"""ctypes bindings for the native runtime library, with lazy build.

``lib`` is None when the shared object is missing and cannot be built;
every caller has a pure-Python fallback (utils.codecs, analysis.unicode_tok,
utils.hashing), so the engine degrades gracefully rather than failing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libxapiand_native.so")
_SRC = os.path.join(_HERE, "native.cpp")
_lock = threading.Lock()


class NativeLib:
    def __init__(self, cdll):
        self._c = cdll
        self._tls = threading.local()
        c = cdll
        c.xt_fnv1a64.restype = ctypes.c_uint64
        c.xt_fnv1a64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        c.xt_lz4_compress.restype = ctypes.c_int64
        c.xt_lz4_compress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_char_p, ctypes.c_int64]
        c.xt_lz4_decompress.restype = ctypes.c_int64
        c.xt_lz4_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_char_p, ctypes.c_int64]
        c.xt_tokenize_ascii.restype = ctypes.c_int64
        c.xt_tokenize_ascii.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        c.xt_delta_encode.restype = ctypes.c_int64
        c.xt_delta_encode.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                                      ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_int64]
        c.xt_delta_decode.restype = ctypes.c_int64
        c.xt_delta_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_uint32),
                                      ctypes.c_int64]
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        c.xt_inv_new.restype = ctypes.c_void_p
        c.xt_inv_free.argtypes = [ctypes.c_void_p]
        c.xt_inv_set_stopwords.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int64]
        c.xt_inv_begin_doc.restype = ctypes.c_int32
        c.xt_inv_begin_doc.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        c.xt_inv_index_text.restype = ctypes.c_int64
        c.xt_inv_index_text.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, i32p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        c.xt_inv_add_term.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int32, ctypes.c_float,
                                      i32p, ctypes.c_int32]
        c.xt_inv_add_bools.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       i32p, ctypes.c_int32]
        c.xt_inv_add_geo_acc.argtypes = [
            ctypes.c_void_p, i64p, i64p, ctypes.c_int32, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
        if hasattr(c, "xt_inv_add_doc"):
            c.xt_inv_add_doc.restype = ctypes.c_int32
            c.xt_inv_add_doc.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
                ctypes.c_int64, f64p, i32p]
        c.xt_inv_end_doc.argtypes = [ctypes.c_void_p, f64p, i32p]
        c.xt_inv_counts.argtypes = [ctypes.c_void_p, i64p, i64p, i64p,
                                    i64p, i64p]
        c.xt_inv_export.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i32p, i64p, f64p, f32p,
            i32p, f32p, i32p, i32p, i32p]
        c.xt_htm_cap_cover.restype = ctypes.c_int64
        c.xt_htm_cap_cover.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, i32p, ctypes.c_int64]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        c.xt_score_topk.restype = ctypes.c_int64
        c.xt_score_topk.argtypes = [
            i32p, f32p, f32p,                      # postings arrays
            u8p, ctypes.c_int32,                   # deleted, has_deletes
            i64p, i64p, f64p, ctypes.c_int32,      # per-term plan
            ctypes.c_double, ctypes.c_double,      # k1, b
            ctypes.c_double, ctypes.c_double,      # min_normlen, lf
            f64p, u8p, i32p,                       # scratch acc/seen/touched
            ctypes.c_int32, i32p, f64p]            # k, out docids/scores
        c.xt_score_topk_global.restype = None
        c.xt_score_topk_global.argtypes = [
            ctypes.c_int32, i64p, i64p, i64p, i64p,
            i64p, i64p, f64p, ctypes.c_int32,
            i32p, i32p, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, f64p, u8p, i32p,
            ctypes.c_int32, i32p, i32p, f64p, i64p]
        c.xt_qseg_new.restype = ctypes.c_void_p
        c.xt_qseg_new.argtypes = [i32p, f32p, f32p, u8p, ctypes.c_int32,
                                  ctypes.c_int32]
        c.xt_qseg_free.argtypes = [ctypes.c_void_p]
        c.xt_qseg_add_valcol.restype = None
        c.xt_qseg_add_valcol.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, u8p,
            i32p, i32p, i32p, i32p, f32p, i32p, ctypes.c_int32,
            i32p, i32p, i32p, i32p]
        c.xt_qseg_build_bigrams.restype = ctypes.c_int64
        c.xt_qseg_build_bigrams.argtypes = [ctypes.c_void_p, i64p, i64p,
                                            ctypes.c_int64, ctypes.c_int64]
        c.xt_qseg_set_positions.restype = None
        c.xt_qseg_set_positions.argtypes = [ctypes.c_void_p, i32p, i32p,
                                            i32p]
        c.xt_qseg_add_geocol.restype = None
        c.xt_qseg_add_geocol.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p, i32p, i32p]
        c.xt_query_exec.restype = ctypes.c_int64
        c.xt_query_exec.argtypes = [
            ctypes.c_void_p,
            i64p, i64p, f64p,                       # term plan
            i32p, i32p, u8p,                        # groups
            ctypes.c_int32, ctypes.c_int32,         # n_groups, driver
            ctypes.c_double, ctypes.c_double,       # k1, b
            ctypes.c_double, ctypes.c_double,       # min_normlen, lf
            i32p, i32p, ctypes.c_int32,             # filters
            i32p, i32p, i32p, i32p, ctypes.c_int32,  # geo
            ctypes.c_int32, ctypes.c_int32,         # sort mode/slot
            i32p, i32p, i32p, i32p, u8p,            # phrases
            ctypes.c_int32,
            i32p, i32p, ctypes.c_int32,             # aggs
            ctypes.c_int32, ctypes.c_int32,         # k, count_only
            i32p, f64p,                             # out docids/scores
            f64p, i64p]                             # agg out
        c.xt_score_topk_many.restype = None
        c.xt_score_topk_many.argtypes = [
            i32p, f32p, f32p, u8p, ctypes.c_int32,
            i64p, i64p, f64p, i32p, i32p, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, f64p, u8p, i32p,
            ctypes.c_int32, i32p, f64p, i64p]

    def htm_cap_cover(self, lat: float, lon: float, radius_rad: float,
                      level: int, max_trixels: int = 4096):
        """Bit-identical native htm.cover() for Cap regions; None if the
        buffer overflows (caller falls back / raises like Python)."""
        # reusable thread-local buffer: a fresh 32KB ctypes array (and
        # its type-cache lookup) per call was ~half this path's cost on
        # geo-profile indexing; bulk.py's prepare pool calls this from
        # worker threads, hence thread-local not instance state
        tl = self._tls
        buf = getattr(tl, "cover_buf", None)
        if buf is None or len(buf) < 2 * max_trixels:
            buf = tl.cover_buf = (ctypes.c_int32 * (2 * max_trixels))()
        n = self._c.xt_htm_cap_cover(lat, lon, radius_rad, level, buf,
                                     max_trixels)
        if n < 0:
            return None
        return [(buf[2 * i], buf[2 * i + 1]) for i in range(n)]

    def fnv1a64(self, data: bytes) -> int:
        return self._c.xt_fnv1a64(data, len(data))

    def lz4_compress(self, data: bytes) -> bytes | None:
        cap = len(data) + len(data) // 128 + 64
        out = ctypes.create_string_buffer(cap)
        n = self._c.xt_lz4_compress(data, len(data), out, cap)
        if n < 0:
            return None
        # prefix the raw size (block format does not self-describe it)
        return len(data).to_bytes(4, "little") + out.raw[:n]

    def lz4_decompress(self, data: bytes) -> bytes:
        raw_size = int.from_bytes(data[:4], "little")
        out = ctypes.create_string_buffer(max(raw_size, 1))
        n = self._c.xt_lz4_decompress(data[4:], len(data) - 4, out, raw_size)
        if n != raw_size:
            raise ValueError("LZ4 decompression failed")
        return out.raw[:raw_size]

    def tokenize_ascii(self, text: str):
        """-> list[(token, position)] or None for non-ASCII input."""
        raw = text.encode("ascii", errors="strict") if text.isascii() else None
        if raw is None:
            return None
        cap = len(raw) + 8
        buf = ctypes.create_string_buffer(cap)
        # a token needs >=1 char + a separator, so len//2+2 is a strict
        # upper bound on the token count: no document can overflow it (the
        # old fixed 65536 cap silently dropped terms past ~128KB of ASCII)
        max_tokens = len(raw) // 2 + 2
        spans = (ctypes.c_int32 * (2 * max_tokens))()
        n = self._c.xt_tokenize_ascii(raw, len(raw), buf, cap, spans,
                                      max_tokens)
        if n < 0:
            return None
        out = []
        text_out = buf.raw
        for k in range(n):
            s, ln = spans[2 * k], spans[2 * k + 1]
            out.append((text_out[s:s + ln].decode("ascii"), k))
        return out

    def delta_encode(self, vals) -> bytes:
        import numpy as np

        arr = np.ascontiguousarray(vals, dtype=np.uint32)
        cap = 5 * len(arr) + 16
        out = ctypes.create_string_buffer(cap)
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        n = self._c.xt_delta_encode(ptr, len(arr), out, cap)
        if n < 0:
            raise ValueError("delta encode overflow")
        return out.raw[:n]

    def make_inverter(self, stopwords=None) -> "Inverter":
        return Inverter(self, stopwords)

    def delta_decode(self, data: bytes, max_out: int):
        import numpy as np

        arr = np.zeros(max_out, dtype=np.uint32)
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        n = self._c.xt_delta_decode(data, len(data), ptr, max_out)
        if n < 0:
            raise ValueError("delta decode failed")
        return arr[:n]


_STEM_MODES = {"none": 0, "some": 1, "all": 2, "all_z": 3}
_STOP_MODES = {"none": 0, "all": 1, "stemmed": 2}


class Inverter:
    """Native doc->terms inverter (TermGenerator + glass-inverter analog,
    termgenerator_internal.cc + glass_inverter.cc). Owns the term
    dictionary, postings, and positions; SegmentBuilder drives it and packs
    the exported arrays into a Segment."""

    def __init__(self, nlib: "NativeLib", stopwords=None):
        self._c = nlib._c
        self._h = self._c.xt_inv_new()
        self._prefix_cache: dict = {}  # prefixes tuple -> packed ctypes args
        dl, uq = ctypes.c_double(), ctypes.c_int32()
        self._end_doc_bufs = (dl, uq, (ctypes.byref(dl), ctypes.byref(uq)))
        if stopwords:
            blob = "\n".join(sorted(stopwords)).encode("utf-8")
            self._c.xt_inv_set_stopwords(self._h, blob, len(blob))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._c.xt_inv_free(h)

    def begin_doc(self, docid: int):
        self._c.xt_inv_begin_doc(self._h, docid)

    def index_text(self, text: str, prefixes, pos_base: int, wdf_inc: float,
                   with_positions: bool, stem_strategy: str,
                   stop_strategy: str):
        """-> next position base, or None for non-ASCII input (caller runs
        the Python TermGenerator for this block instead)."""
        if not text.isascii():
            return None
        raw = text.encode("ascii")
        if len(prefixes) > 16:
            # the C ABI caps prefixes per call (namespace partial paths
            # can exceed it); same pos_base per chunk keeps positions and
            # wdf identical to a single pass
            r = None
            for i in range(0, len(prefixes), 16):
                r = self.index_text(text, prefixes[i: i + 16], pos_base,
                                    wdf_inc, with_positions, stem_strategy,
                                    stop_strategy)
            return r
        key = tuple(prefixes)
        cached = self._prefix_cache.get(key)
        if cached is None:
            pbuf = "".join(prefixes).encode("utf-8")
            plens = (ctypes.c_int32 * len(prefixes))(
                *[len(p.encode("utf-8")) for p in prefixes])
            cached = self._prefix_cache[key] = (pbuf, plens, len(prefixes))
        pbuf, plens, np_ = cached
        r = self._c.xt_inv_index_text(
            self._h, raw, len(raw), pbuf, plens, np_,
            pos_base, wdf_inc, 1 if with_positions else 0,
            _STEM_MODES[stem_strategy], _STOP_MODES[stop_strategy])
        return None if r < 0 else int(r)

    def add_bools(self, terms: list):
        """Bulk boolean filter terms (wdf 0): one ctypes crossing for the
        whole accuracy/keyword term set of a document."""
        if not terms:
            return
        raws = [t.encode("utf-8") for t in terms]
        lens = (ctypes.c_int32 * len(raws))(*map(len, raws))
        self._c.xt_inv_add_bools(self._h, b"".join(raws), lens, len(raws))

    def add_geo_acc(self, ranges, levels, max_level: int, prefix: str):
        """Geo accuracy terms computed natively from HTM id ranges
        (ancestors per level + decimal formatting in C++; mirrors
        accuracy.py geo_terms / htm.py ancestors_of_ranges)."""
        n = len(ranges)
        if not n or not levels:
            return
        starts = (ctypes.c_int64 * n)(*[int(r[0]) for r in ranges])
        ends = (ctypes.c_int64 * n)(*[int(r[1]) for r in ranges])
        lv = (ctypes.c_int32 * len(levels))(*[int(x) for x in levels])
        p = prefix.encode("utf-8")
        self._c.xt_inv_add_geo_acc(self._h, starts, ends, n, lv,
                                   len(levels), max_level, p, len(p))

    def add_term(self, term: str, wdf: float, positions=None):
        raw = term.encode("utf-8")
        if positions:
            arr = (ctypes.c_int32 * len(positions))(*positions)
            self._c.xt_inv_add_term(self._h, raw, len(raw), wdf, arr,
                                    len(positions))
        else:
            self._c.xt_inv_add_term(self._h, raw, len(raw), wdf, None, 0)

    def end_doc(self):
        dl, uq, refs = self._end_doc_bufs
        self._c.xt_inv_end_doc(self._h, *refs)
        return dl.value, uq.value

    @property
    def can_add_doc(self) -> bool:
        return hasattr(self._c, "xt_inv_add_doc")

    def add_doc(self, docid: int, buf: bytes):
        """Packed single-crossing document add (xt_inv_add_doc): one ctypes
        call indexes the whole analysed doc — terms, booleans, text
        (tokenize+stem), geo/date/numeric accuracy term generation — in C++.
        Returns (doclen, uniq). Raises on malformed buffers (the packer in
        models/builder.py validates before packing, so this never fires on
        the production path)."""
        dl, uq, _ = self._end_doc_bufs
        rc = self._c.xt_inv_add_doc(self._h, docid, buf, len(buf),
                                    ctypes.byref(dl), ctypes.byref(uq))
        if rc != 0:
            raise RuntimeError("xt_inv_add_doc: malformed packed doc")
        return dl.value, uq.value

    def export(self):
        """-> dict of packed numpy arrays + the sorted term table."""
        import numpy as np

        nt, npost, npos, tbytes, maxlen = (ctypes.c_int64() for _ in range(5))
        self._c.xt_inv_counts(self._h, *(ctypes.byref(x) for x in
                                         (nt, npost, npos, tbytes, maxlen)))
        nt, npost, npos = nt.value, npost.value, npos.value
        tbytes, maxlen = tbytes.value, maxlen.value
        term_buf = ctypes.create_string_buffer(max(tbytes, 1))
        term_lens = np.zeros(max(nt, 1), np.int32)
        offsets = np.zeros(nt + 1, np.int64)
        collfreq = np.zeros(max(nt, 1), np.float64)
        maxwdf = np.zeros(max(nt, 1), np.float32)
        docids = np.zeros(max(npost, 1), np.int32)
        wdf = np.zeros(max(npost, 1), np.float32)
        posoff = np.zeros(max(npost, 1), np.int32)
        poslen = np.zeros(max(npost, 1), np.int32)
        positions = np.zeros(max(npos, 1), np.int32)

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        self._c.xt_inv_export(
            self._h, term_buf, p(term_lens, ctypes.c_int32),
            p(offsets, ctypes.c_int64), p(collfreq, ctypes.c_double),
            p(maxwdf, ctypes.c_float), p(docids, ctypes.c_int32),
            p(wdf, ctypes.c_float), p(posoff, ctypes.c_int32),
            p(poslen, ctypes.c_int32), p(positions, ctypes.c_int32))
        return {"n_terms": nt, "n_postings": npost, "max_post_len": maxlen,
                "term_buf": term_buf.raw[:tbytes], "term_lens": term_lens,
                "offsets": offsets, "collfreq": collfreq, "maxwdf": maxwdf,
                "docids": docids[:npost], "wdf": wdf[:npost],
                "posoff": posoff[:npost], "poslen": poslen[:npost],
                "positions": positions[:npos]}


# ---------------------------------------------------------------------------
# Everything above is the JAX package's native/__init__.py up to its loader,
# copied as it is (a test holds the two texts equal). Below is the port's own
# loader. The JAX package builds at import, beside its source; the port
# builds at the first read of ``lib`` (a module __getattr__), into the
# gitignored xapiand_tpu_torch/_build/ keyed by a hash of the sources and
# flags, and moves the finished library into place with os.replace, so
# processes building at once never load a half-written file. ``lib`` is
# None when the build fails, and every caller falls back to pure Python, as
# in the JAX package; build_info says what happened. The library is built
# from stem_export.cpp, which includes native.cpp and exports its English
# stemmer per word (``stem_english``; analysis/stem.py).

import hashlib  # noqa: E402
import time  # noqa: E402

_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# the JAX package's g++ flags: -ffp-contract=off keeps the HTM cover
# bit-identical to the Python htm.cover
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_EXPORTS = os.path.join(_HERE, "stem_export.cpp")
build_info: dict = {}
_state: dict = {}


def build() -> str:
    """Compile native.cpp into _build/native-<hash>/libxapiand_native.so
    (once per source hash) and return its path; raises when g++ fails."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in (_SRC, _EXPORTS):
        with open(path, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_BUILD_DIR, "native-" + h.hexdigest()[:16])
    so = os.path.join(out_dir, "libxapiand_native.so")
    if os.path.exists(so):
        build_info.update(path=so, seconds=0.0, cached=True)
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = os.path.join(out_dir, f"libxapiand_native.{os.getpid()}."
                                f"{threading.get_ident()}.tmp.so")
    t0 = time.time()
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _EXPORTS], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info.update(path=so, seconds=time.time() - t0, cached=False)
    return so


def _load():
    with _lock:
        if "lib" not in _state:
            try:
                cdll = ctypes.CDLL(build())
                cdll.xt_stem_english.restype = ctypes.c_int64
                cdll.xt_stem_english.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                    ctypes.c_int64]
                _state["lib"] = NativeLib(cdll)
            except (OSError, subprocess.SubprocessError) as e:
                build_info["error"] = str(e)
                _state["lib"] = None
        return _state["lib"]


def __getattr__(name):
    if name == "lib":
        return _load()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def stem_english(word: str) -> str:
    """The Porter2 stem of one lowercase word, by native.cpp's stemmer (the
    one the inverter stems with); raises when the library did not build."""
    nl = _load()
    if nl is None:
        raise RuntimeError("the native library did not build: "
                           + build_info.get("error", "unknown error"))
    raw = word.encode("utf-8")
    cap = len(raw) + 8
    buf = ctypes.create_string_buffer(cap)
    n = nl._c.xt_stem_english(raw, len(raw), buf, cap)
    if n < 0:
        raise ValueError(f"stem of {word!r} longer than {cap} bytes")
    return buf.raw[:n].decode("utf-8", errors="surrogateescape")
