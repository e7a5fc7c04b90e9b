"""Host C++/OpenMP terrain noise, built with the host compiler on first use.

Counterpart of `scenedreamer_tpu/native/__init__.py`, with its own copy
of `simplex.cpp`. The library is compiled with g++ into the port's
gitignored build directory (`utils/build.py`) and bound with ctypes.
When it does not compile, `scene/noise.py` takes its numpy path, which
gives identical output (the JAX module's documented behaviour). Set
SCENEDREAMER_NO_NATIVE=1 to force the numpy path.
"""
import ctypes
import os
import threading

from scenedreamer_tpu_torch.utils.build import finish_compile, start_compile

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_STATE = {'tried': False, 'lib': None}

# no -ffast-math and no FMA contraction: outputs must equal the numpy path
_FLAGS = ['-O3', '-ffp-contract=off', '-fopenmp', '-shared', '-fPIC']


def _build(src):
    for extra in (['-march=native'], []):
        try:
            return finish_compile(*start_compile(src, ['g++'] + extra
                                                 + _FLAGS, '_simplex'))[0]
        except (OSError, RuntimeError):
            continue
    return None


def load_simplex():
    """Return the ctypes library with fbm3_grid / fbm3_points, or None."""
    if os.environ.get('SCENEDREAMER_NO_NATIVE'):
        return None
    with _LOCK:
        if _STATE['tried']:
            return _STATE['lib']
        _STATE['tried'] = True
        so = _build(os.path.join(_DIR, 'simplex.cpp'))
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.fbm3_grid.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, i64p, f64p]
        lib.fbm3_grid.restype = None
        lib.fbm3_points.argtypes = [
            ctypes.c_int64, f64p, f64p, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, i64p, f64p]
        lib.fbm3_points.restype = None
        _STATE['lib'] = lib
        return lib
