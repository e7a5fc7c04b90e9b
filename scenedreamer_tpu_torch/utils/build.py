"""Build-on-first-use for the port's native libraries.

Shared libraries go into `scenedreamer_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the source, the headers it includes
and the compiler command, so a changed source, header or flag set never
loads a stale library. Each
build writes a process-unique temporary file and renames it into
place, so concurrent builders (test workers) never load a half-written
library.
"""
import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '_build')


def library_path(src, cmd, stem, deps=()):
    """Path of the library built from `src` (including the files `deps`)
    by `cmd` (a list whose output argument is appended by
    `start_compile`)."""
    h = hashlib.sha1()
    for path in (src,) + tuple(deps):
        with open(path, 'rb') as f:
            h.update(f.read())
    h.update('\0'.join(cmd).encode())
    return os.path.join(BUILD_DIR, f'{stem}-{h.hexdigest()[:12]}.so')


def start_compile(src, cmd, stem, deps=()):
    """Start compiling `src` (including the files `deps`) unless its
    library exists. Returns (path, Popen or None); finish with
    `finish_compile`."""
    out = library_path(src, cmd, stem, deps)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.Popen(cmd + [src, '-o', tmp],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    proc.tmp_path = tmp
    return out, proc


def finish_compile(out, proc, timeout=600):
    """Wait for a build from `start_compile`; returns (path, compiler
    output, or '' for a library that was already built). Raises with
    the compiler output if the build failed."""
    if proc is None:
        return out, ''
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f'build of {out} failed:\n'
                           + log.decode(errors='replace'))
    os.replace(proc.tmp_path, out)
    return out, log.decode(errors='replace')
