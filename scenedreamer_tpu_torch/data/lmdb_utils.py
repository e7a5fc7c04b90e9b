"""LMDB construction and reading for paired datasets.

Copy of `scenedreamer_tpu/data/lmdb_utils.py` (reference
`imaginaire/utils/lmdb.py:43-216` build_lmdb / create_metadata and
`scripts/build_lmdb.py`): each data type (images, seg_maps) gets its own
database whose values are the RAW file bytes keyed by the file's path
relative to the type's folder, plus an `all_filenames.json` key list.

Host-side IO. With the `lmdb` package installed the real LMDB format is
written and read (the reference's databases). Without it, a key-value
store on the standard library's sqlite3 (`fallback_kv.sqlite` inside the
database directory) stands in, the same files the JAX package writes, so
either package reads the other's databases; readers detect which format
a directory holds. The substitute is not the LMDB on-disk format.
"""
import json
import os

_FALLBACK_DB = 'fallback_kv.sqlite'


def _try_lmdb():
    try:
        import lmdb
        return lmdb
    except ImportError:
        return None


class _SqliteKV:
    """Minimal raw-bytes KV store over stdlib sqlite3, the substitute
    for the lmdb package (the same get() / keys surface). A reader opens
    one read-only connection per thread (sqlite3 refuses a connection
    made in another thread), so the loader's worker threads can read;
    the JAX package's single connection cannot be read from them."""

    def __init__(self, path, readonly=True):
        import sqlite3
        import threading
        self.db = os.path.join(path, _FALLBACK_DB)
        if readonly and not os.path.exists(self.db):
            raise FileNotFoundError(self.db)
        self._sqlite, self._local = sqlite3, threading.local()
        if not readonly:
            self._local.conn = sqlite3.connect(self.db)
            self.conn.execute(
                'CREATE TABLE IF NOT EXISTS kv '
                '(k TEXT PRIMARY KEY, v BLOB)')

    @property
    def conn(self):
        conn = getattr(self._local, 'conn', None)
        if conn is None:
            conn = self._local.conn = self._sqlite.connect(
                f'file:{self.db}?mode=ro', uri=True)
        return conn

    def put(self, key, value):
        self.conn.execute('INSERT OR REPLACE INTO kv VALUES (?, ?)',
                          (key, value))

    def get(self, key):
        row = self.conn.execute('SELECT v FROM kv WHERE k = ?',
                                (key,)).fetchone()
        if row is None:
            raise KeyError(key)
        return bytes(row[0])

    def keys(self):
        return [r[0] for r in
                self.conn.execute('SELECT k FROM kv ORDER BY k')]

    def close(self):
        self.conn.commit()
        self.conn.close()


def build_lmdb(file_paths, keys, output_path, map_size=None,
               write_frequency=1000):
    """Write raw file bytes into an LMDB (`utils/lmdb.py:56-74`), or
    into the sqlite substitute when the lmdb package is absent."""
    lmdb = _try_lmdb()
    os.makedirs(output_path, exist_ok=True)
    if lmdb is None:
        kv = _SqliteKV(output_path, readonly=False)
        for path, key in zip(file_paths, keys):
            with open(path, 'rb') as f:
                kv.put(key, f.read())
        kv.close()
    else:
        if map_size is None:
            map_size = sum(os.path.getsize(p)
                           for p in file_paths) * 2 + 10**8
        env = lmdb.open(output_path, map_size=map_size)
        txn = env.begin(write=True)
        for i, (path, key) in enumerate(zip(file_paths, keys)):
            with open(path, 'rb') as f:
                txn.put(key.encode('ascii'), f.read())
            if (i + 1) % write_frequency == 0:
                txn.commit()
                txn = env.begin(write=True)
        txn.commit()
        env.close()
    with open(os.path.join(output_path, 'all_filenames.json'), 'w') as f:
        json.dump(sorted(keys), f)


def build_paired_lmdbs(data_root, output_root,
                       data_types=('images', 'seg_maps')):
    """Folder tree {data_root}/{type}/... -> {output_root}/{type} LMDBs
    (`scripts/build_lmdb.py` flow). Only stems present in every type are
    kept (paired requirement, `utils/lmdb.py:132-216`)."""
    per_type = {}
    for t in data_types:
        root = os.path.join(data_root, t)
        files = sorted(
            os.path.join(dp, f)
            for dp, _, fs in os.walk(root) for f in fs
            if not f.startswith('.'))
        per_type[t] = {
            os.path.splitext(os.path.relpath(p, root))[0]: p
            for p in files}
    common = sorted(set.intersection(*[set(v) for v in per_type.values()]))
    if not common:
        raise FileNotFoundError(f'no paired files under {data_root}')
    for t in data_types:
        paths = [per_type[t][stem] for stem in common]
        keys = [os.path.relpath(p, os.path.join(data_root, t))
                for p in paths]
        build_lmdb(paths, keys, os.path.join(output_root, t))
    return len(common)


class LMDBReader:
    """Read-only raw-bytes LMDB (`utils/lmdb.py:17-54` Dataset half).

    Auto-detects the directory format: a real LMDB (data.mdb) is read
    with the lmdb package; a `fallback_kv.sqlite` substitute is read
    with stdlib sqlite3."""

    def __init__(self, path):
        self._kv = None
        if os.path.exists(os.path.join(path, _FALLBACK_DB)):
            self._kv = _SqliteKV(path, readonly=True)
            keys = self._kv.keys()
        else:
            lmdb = _try_lmdb()
            if lmdb is None:
                raise ImportError(
                    f'{path} holds a real LMDB but the lmdb package is '
                    'not installed; rebuild it with cli.build_db (the '
                    'sqlite substitute) or use the folder backend')
            self.env = lmdb.open(
                path, max_readers=126, readonly=True, lock=False,
                readahead=False, meminit=False)
            with self.env.begin() as txn:
                keys = [k.decode('ascii') for k, _ in txn.cursor()]
        meta = os.path.join(path, 'all_filenames.json')
        if os.path.exists(meta):
            with open(meta) as f:
                self.keys = json.load(f)
        else:
            self.keys = keys

    def get(self, key):
        if self._kv is not None:
            return self._kv.get(key)
        with self.env.begin(write=False) as txn:
            buf = txn.get(key.encode('ascii'))
        if buf is None:
            raise KeyError(key)
        return bytes(buf)
