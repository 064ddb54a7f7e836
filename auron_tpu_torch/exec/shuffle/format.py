"""Compacted shuffle block format, numpy only (port of
``auron_tpu/exec/shuffle/format.py``).

The layout is the JAX package's, so either engine reads the other's files:

    data file  := concat of per-partition regions (partition order)
                  | 16-byte "AURONPAR" pair trailer
    region     := block*
    block      := u64-LE payload length | payload
    payload    := "AUB2" | u8 ver=2 | u8 pad | u16 ncols | u32 nrows
                | u32 schema_len | Arrow IPC schema message + EOS
                | column*
    column     := u8 enc | u8 has_validity
                | [u32 vlen | packbits(validity, little)]
                | u32 plen | enc payload
    index file := (num_partitions + 1) u64-LE offsets | pair magic + tag

Ported here: the framing, the index and pair trailer (``format.py:90-169``)
and the v2 block for fixed-width columns with the plane encoders RAW,
BITPACK, RLE, PACKBITS, SPARSE and SCALED and their deterministic chooser
(``format.py:272-533``, copied; SCALED is the numpy twin, which makes the
same bytes as the JAX package's native kernels). The writer's rules that
decide the bytes carry over: no validity section when a column has no
NULLs, NULL lanes zeroed before encoding, a plane at least half NULL takes
SPARSE. The general codec (``fallback_codec``: ``exec.shuffle.encoding.
fallback.codec``, auto = ``spill.compression.codec``, lz4 by default)
compresses, through ``columnar/codecs.py`` (``pa.Codec``), a raw int plane
or a float plane no light-weight encoding fits once it holds at least
1,024 bytes and the frame saves more than its 9-byte header: ENC_CODEC,
``u8 codec id | u64 raw length | frame`` (``format.py:465-533, 685-692``).
A codec the process cannot have (pyarrow missing, or a build without it)
degrades to the light-weight encodings with one stderr warning per name
(``format.py:247-269``).

The schema section is a minimal Arrow IPC schema message written without
pyarrow (``pa.ipc.read_schema`` reads it, so the JAX reader reads the
port's files); the port's reader skips it and takes the column types from
its plan schema. A dictionary-encoded string, binary, LIST, MAP or STRUCT
column is an ENC_DICT column as in the JAX writer (``format.py:618-638``):
the vocabulary rides once per block as a single-column Arrow IPC stream,
written and read here without pyarrow (``arrow_column_stream``,
``read_arrow_column_stream``), then the int32 codes as an int plane. Its
host plane is a ``DictCodes`` (codes + vocabulary); the chunks staged into
one block are merged onto one vocabulary (a nested one laid end to end, and
pruned to the entries the block's rows use when it is written). The JAX
block format holds a dictionary-typed nested column as ENC_DICT while its
vocabulary has at most ``exec.shuffle.encoding.dict.max`` entries; the JAX
shuffle writer materializes nested columns, so its blocks carry them as
ENC_ARROW. Every decimal column, decimal64 and wide alike, is an
ENC_DEC128 column as the JAX writer writes Arrow decimal128 planes
(``format.py:669-681``): the 128-bit unscaled values as a lo and a hi
int64 sub-plane, each through the int-plane chooser, built here from the
int64 values or a wide vocabulary's unscaled integers. Reading one back,
a decimal64 keeps the lanes whose value fits int64 (the others turn NULL,
reference ``reader.py:138-147``); a wide decimal becomes codes into a
vocabulary of its distinct values. A wide-decimal ENC_DICT column (the
JAX writer's form for a small dictionary) reads its Decimal128 vocabulary
stream here too. A dictionary column whose vocabulary exceeds
``exec.shuffle.encoding.dict.max`` entries is an ENC_ARROW column: its
values materialized as a single-column Arrow IPC stream under the codec
(``format.py:602-644, 782``, written by ``columnar/arrow_ipc.py``); the
reader reads ENC_ARROW columns of every type, the JAX writer's nested
columns among them. A v1 block (an Arrow IPC stream, compressed or not:
what the reference's writers write with ``exec.shuffle.encoding=off``,
``encode_v1_block`` here) decodes through ``columnar/arrow_ipc.py``.
"""

from __future__ import annotations

import struct
import sys
import threading
from typing import Iterator

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar import arrow_ipc
from auron_tpu_torch.columnar.arrow_c import HostBatch, array_from_numpy, array_from_pylist
from auron_tpu_torch.columnar.batch import empty_dict, empty_entry, merge_vocab, object_array
from auron_tpu_torch.columnar import codecs
from auron_tpu_torch.utils.config import (
    SHUFFLE_ENCODING, SHUFFLE_ENCODING_FALLBACK, SPILL_COMPRESSION_CODEC, resolve_tri,
)

# ---------------------------------------------------------------------------
# framing, index, pair trailer
# ---------------------------------------------------------------------------

PAIR_MAGIC = 0x41_55_52_4F_4E_50_41_52  # "AURONPAR"


def iter_block_payloads(data: bytes) -> Iterator[bytes]:
    """Walk the length-prefixed framing, yielding raw block payloads."""
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        if pos + length > n:
            raise ValueError(
                f"corrupt shuffle block: length {length} at offset {pos - 8} "
                f"overruns the region ({n} bytes)"
            )
        yield data[pos : pos + length]
        pos += length


def write_index(path: str, offsets: list[int], pair_tag: int | None = None) -> None:
    with open(path, "wb") as f:
        for o in offsets:
            f.write(struct.pack("<Q", o))
        if pair_tag is not None:
            f.write(struct.pack("<QQ", PAIR_MAGIC, pair_tag))


def data_trailer(pair_tag: int) -> bytes:
    """16-byte trailer after the last offset of a data file (invisible to
    offset-sliced reads)."""
    return struct.pack("<QQ", PAIR_MAGIC, pair_tag)


def read_index_tagged(path: str) -> tuple[list[int], int | None]:
    with open(path, "rb") as f:
        raw = f.read()
    words = [struct.unpack_from("<Q", raw, i)[0] for i in range(0, len(raw) - 7, 8)]
    if len(words) >= 3 and words[-2] == PAIR_MAGIC:
        return words[:-2], words[-1]
    return words, None


def read_data_tag(path: str, last_offset: int) -> int | None:
    """The pair tag from a data file's trailer (None for untagged files)."""
    with open(path, "rb") as f:
        f.seek(last_offset)
        tail = f.read(16)
    if len(tail) == 16:
        magic, tag = struct.unpack("<QQ", tail)
        if magic == PAIR_MAGIC:
            return tag
    return None


# ---------------------------------------------------------------------------
# v2 plane encoders (copied from auron_tpu/exec/shuffle/format.py:272-533)
# ---------------------------------------------------------------------------

V2_MAGIC = b"AUB2"

ENC_RAW = 0
ENC_BITPACK = 1
ENC_RLE = 2
ENC_PACKBITS = 3
ENC_CODEC = 4
ENC_ARROW = 5
ENC_DICT = 6
ENC_DEC128 = 7
ENC_SCALED = 8
ENC_SPARSE = 9

ENC_NAMES = {
    ENC_RAW: "raw", ENC_BITPACK: "bitpack", ENC_RLE: "rle",
    ENC_PACKBITS: "packbits", ENC_CODEC: "codec", ENC_ARROW: "arrow",
    ENC_DICT: "dict", ENC_DEC128: "dec128", ENC_SCALED: "scaled",
    ENC_SPARSE: "sparse",
}

_codec_warned: set[str] = set()
_codec_warn_lock = threading.Lock()


def shuffle_encoding_enabled(conf) -> bool:
    """The exec.shuffle.encoding tri-state (auto = on)."""
    return resolve_tri(conf.get(SHUFFLE_ENCODING), True)


def fallback_codec(conf) -> str | None:
    """The general codec for planes no light-weight encoding fits
    (``format.py:_fallback_codec``): the named one, else lz4, else None. A
    name the process cannot have degrades with one stderr warning per
    name."""
    name = conf.get(SHUFFLE_ENCODING_FALLBACK)
    if name == "auto":
        name = conf.get(SPILL_COMPRESSION_CODEC)
    if name in (None, "none"):
        return None
    for candidate in (name, "lz4"):
        if codecs.available(candidate):
            return candidate
        with _codec_warn_lock:
            if candidate not in _codec_warned:
                _codec_warned.add(candidate)
                sys.stderr.write(
                    f"auron-tpu: shuffle encoding fallback codec '{candidate}' "
                    "unavailable; degrading to light-weight encodings only\n")
    return None


def v1_codec(conf) -> str | None:
    """The codec of a v1 block (``format.py:_codec``): ``spill.compression.
    codec``, None for none."""
    c = conf.get(SPILL_COMPRESSION_CODEC)
    return None if c in (None, "none") else c


_CODEC_MIN_BYTES = 1024


def _codec_plane(codec: str | None, raw: bytes) -> bytes | None:
    """An ENC_CODEC payload of ``raw`` when it pays (>= 1,024 bytes, and the
    frame saves more than the 9-byte header), else None."""
    if codec is None or len(raw) < _CODEC_MIN_BYTES:
        return None
    comp = codecs.compress(codec, raw)
    if len(comp) + 9 >= len(raw):
        return None
    return struct.pack("<BQ", codecs.CODEC_IDS[codec], len(raw)) + comp


def _decode_codec(payload: bytes, n: int, dtype: np.dtype) -> np.ndarray:
    cid, raw_len = struct.unpack_from("<BQ", payload, 0)
    raw = codecs.decompress(codecs.CODEC_BY_ID[cid], payload[9:], raw_len)
    return np.frombuffer(raw, dtype, count=n)


def _for_width(lo: int, hi: int) -> int:
    """Frame-of-reference byte width for [lo, hi]; 8 = no narrowing."""
    span = hi - lo
    for w in (1, 2, 4):
        if span < (1 << (8 * w)):
            return w
    return 8


def _pack_for(a: np.ndarray, ref: int, width: int) -> bytes:
    if width == 8:
        return struct.pack("<qB", 0, 8) + a.astype(np.int64).tobytes()
    off = (a.astype(np.int64) - np.int64(ref)).astype(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[width])
    return struct.pack("<qB", ref, width) + off.tobytes()


def _unpack_for(payload: bytes, n: int, dtype: np.dtype) -> np.ndarray:
    ref, width = struct.unpack_from("<qB", payload, 0)
    if width == 8:
        return np.frombuffer(payload, np.int64, count=n, offset=9).astype(dtype, copy=False)
    off = np.frombuffer(payload, {1: np.uint8, 2: np.uint16, 4: np.uint32}[width],
                        count=n, offset=9)
    return (off.astype(np.int64) + np.int64(ref)).astype(dtype, copy=False)


def _as_bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)
    return a


def _run_stats(a: np.ndarray):
    a = _as_bits(a)
    if len(a) == 0:
        return 0, None
    neq = a[1:] != a[:-1]
    return 1 + int(np.count_nonzero(neq)), neq


def _starts_from(neq: np.ndarray | None) -> np.ndarray:
    if neq is None:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(([0], np.flatnonzero(neq) + 1))


def _emit_rle(a: np.ndarray, neq, n: int, nruns: int, vw: int | None):
    starts = _starts_from(neq)
    lengths = np.diff(np.concatenate((starts, [n])))
    vals = a[starts]
    lo, hi = int(vals.min()), int(vals.max())
    if not (-(2**63) <= lo and hi < 2**63):
        return None
    lpart = _pack_for(lengths, 0, _for_width(0, int(lengths.max())))
    vpart = _pack_for(vals, lo, vw if vw is not None else _for_width(lo, hi))
    return ENC_RLE, struct.pack("<I", nruns) + lpart + vpart


def encode_int_plane(a: np.ndarray) -> tuple[int, bytes]:
    """Deterministic chooser for integer planes: RLE on the run count
    alone when runs dominate, else the smallest of RLE, FOR-bitpack, raw."""
    n = len(a)
    raw_bytes = n * a.dtype.itemsize
    if n == 0:
        return ENC_RAW, a.tobytes()
    nruns, neq = _run_stats(a)
    if 4 + (9 + nruns * _for_width(0, n)) + (9 + nruns * 8) < raw_bytes // 2:
        out = _emit_rle(a, neq, n, nruns, None)
        if out is not None:
            return out
    lo, hi = int(a.min()), int(a.max())
    if not (-(2**63) <= lo and hi < 2**63):
        return ENC_RAW, a.tobytes()
    vw = _for_width(lo, hi)
    bitpack_bytes = 9 + n * vw if vw < a.dtype.itemsize else raw_bytes + 9
    lw = _for_width(0, n)
    rle_bytes = 4 + (9 + nruns * lw) + (9 + nruns * vw)
    best = min(rle_bytes, bitpack_bytes, raw_bytes)
    if best == rle_bytes and rle_bytes < raw_bytes:
        out = _emit_rle(a, neq, n, nruns, vw)
        if out is not None:
            return out
    if best == bitpack_bytes and vw < a.dtype.itemsize:
        return ENC_BITPACK, _pack_for(a, lo, vw)
    return ENC_RAW, a.tobytes()


def decode_int_plane(enc: int, payload: bytes, n: int, dtype: np.dtype) -> np.ndarray:
    if enc == ENC_RAW:
        return np.frombuffer(payload, dtype, count=n)
    if enc == ENC_BITPACK:
        return _unpack_for(payload, n, dtype)
    if enc == ENC_RLE:
        (nruns,) = struct.unpack_from("<I", payload, 0)
        pos = 4
        lwidth = payload[pos + 8]
        lbytes = 9 + nruns * {1: 1, 2: 2, 4: 4, 8: 8}[lwidth]
        lengths = _unpack_for(payload[pos : pos + lbytes], nruns, np.int64)
        pos += lbytes
        vals = _unpack_for(payload[pos:], nruns, dtype)
        return np.repeat(vals, lengths)
    if enc == ENC_CODEC:
        return _decode_codec(payload, n, dtype)
    raise ValueError(f"bad int plane encoding {enc}")


_SCALED_MAX_EXP = 4


def _scaled_exponent(a: np.ndarray) -> int | None:
    """Smallest e <= 4 such that round(v * 10^e) / 10^e reproduces a strided
    sample bitwise; ``_scaled_pack`` then verifies the whole plane."""
    sample = np.ascontiguousarray(a[:: max(1, len(a) // 2048)][:2048])
    for e in range(_SCALED_MAX_EXP + 1):
        if _scaled_pack(sample, e) is not None:
            return e
    return None


def _scaled_pack(a: np.ndarray, e: int) -> bytes | None:
    """Verify + pack a decimal-in-float plane: the decode is simulated
    exactly (round(a*s)/s must reproduce ``a`` bitwise), magnitudes stay
    below 2^53, and -0.0 refuses. Returns the ENC_SCALED payload or None."""
    s = a.dtype.type(10.0**e)
    with np.errstate(invalid="ignore", over="ignore"):
        t = a * s
        np.round(t, out=t)
        if not np.array_equal(t / s, a):  # NaN/Inf refuse here too
            return None
        lo_f, hi_f = t.min(), t.max()
        if not (float(-(2**53)) < lo_f and hi_f < float(2**53)):
            return None
        lo, hi = int(lo_f), int(hi_f)
        if lo <= 0 <= hi and np.any(np.signbit(a) & (t == 0)):
            return None
    vw = _for_width(lo, hi)
    if vw == 8:
        payload = struct.pack("<qB", 0, 8) + t.astype(np.int64).tobytes()
    else:
        off = (t.astype(np.int64) - np.int64(lo)).astype(
            {1: np.uint8, 2: np.uint16, 4: np.uint32}[vw])
        payload = struct.pack("<qB", lo, vw) + off.tobytes()
    return struct.pack("<BB", e, ENC_BITPACK) + payload


def encode_float_plane(a: np.ndarray, codec: str | None = None) -> tuple[int, bytes]:
    """Floats: SCALED when the plane is decimal-in-float, RLE when runs
    dominate (bit-pattern equality), else the general codec, else raw."""
    n = len(a)
    if n:
        e = _scaled_exponent(a)
        if e is not None:
            payload = _scaled_pack(a, e)
            if payload is not None:
                return ENC_SCALED, payload
    raw = a.tobytes()
    if n:
        nruns, neq = _run_stats(a)
        rle_bytes = 4 + (9 + nruns * _for_width(0, n)) + nruns * a.dtype.itemsize
        if rle_bytes < len(raw):
            starts = _starts_from(neq)
            lengths = np.diff(np.concatenate((starts, [n])))
            lpart = _pack_for(lengths, 0, _for_width(0, int(lengths.max())))
            return ENC_RLE, struct.pack("<I", nruns) + lpart + a[starts].tobytes()
    comp = _codec_plane(codec, raw)
    if comp is not None:
        return ENC_CODEC, comp
    return ENC_RAW, raw


def decode_float_plane(enc: int, payload: bytes, n: int, dtype: np.dtype) -> np.ndarray:
    if enc == ENC_RAW:
        return np.frombuffer(payload, dtype, count=n)
    if enc == ENC_SCALED:
        e, ienc = struct.unpack_from("<BB", payload, 0)
        ints = decode_int_plane(ienc, payload[2:], n, np.dtype(np.int64))
        # exact: the encoder verified that this division reproduces the plane
        return (ints.astype(dtype) / dtype.type(10.0**e)).astype(dtype, copy=False)
    if enc == ENC_RLE:
        (nruns,) = struct.unpack_from("<I", payload, 0)
        pos = 4
        lwidth = payload[pos + 8]
        lbytes = 9 + nruns * {1: 1, 2: 2, 4: 4, 8: 8}[lwidth]
        lengths = _unpack_for(payload[pos : pos + lbytes], nruns, np.int64)
        pos += lbytes
        vals = np.frombuffer(payload, dtype, count=nruns, offset=pos)
        return np.repeat(vals, lengths)
    if enc == ENC_CODEC:
        return _decode_codec(payload, n, dtype)
    raise ValueError(f"bad float plane encoding {enc}")


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------

_INT_KINDS = (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32, T.TypeKind.INT64,
              T.TypeKind.DATE32, T.TypeKind.TIMESTAMP)


def plane_kind(dtype: T.DataType) -> str:
    """"int", "float" or "bool": the v2 plane family of a fixed-width type."""
    if dtype.kind in _INT_KINDS:
        return "int"
    if dtype.is_float:
        return "float"
    if dtype.kind == T.TypeKind.BOOL:
        return "bool"
    raise NotImplementedError(
        f"shuffle columns of type {dtype} are not in this slice of the port")


class DictCodes:
    """A dictionary column's host plane: int32 ``codes`` into ``vocab`` (a
    numpy object array). Slices and lengths act on the codes."""

    def __init__(self, codes: np.ndarray, vocab: np.ndarray):
        self.codes = codes
        self.vocab = vocab

    def __len__(self) -> int:
        return len(self.codes)

    def __getitem__(self, sl) -> "DictCodes":
        return DictCodes(self.codes[sl], self.vocab)

    @property
    def nbytes(self) -> int:
        return self.codes.nbytes

    @staticmethod
    def concat(parts: list["DictCodes"], nested: bool = False) -> "DictCodes":
        """One plane over one merged vocabulary (first-occurrence order); a
        ``nested`` column's vocabularies are laid end to end instead, each
        part's codes shifted by the entries before it."""
        if nested:
            starts = np.cumsum([0] + [len(p.vocab) for p in parts[:-1]])
            return DictCodes(np.concatenate([np.clip(p.codes, 0, len(p.vocab) - 1) + s
                                             for p, s in zip(parts, starts)]).astype(np.int32),
                             np.concatenate([p.vocab for p in parts]))
        vocab, remaps = merge_vocab([p.vocab for p in parts])
        return DictCodes(np.concatenate([r[np.clip(p.codes, 0, len(r) - 1)]
                                         for p, r in zip(parts, remaps)]).astype(np.int32),
                         vocab)


def _encode_dict_column(vals: DictCodes, valid: np.ndarray | None,
                        dtype: T.DataType) -> tuple[int, bytes | None, bytes]:
    """ENC_DICT: the vocabulary as one Arrow IPC stream, then the codes
    (null lanes zeroed) as an int plane (``format.py:618-638``). A nested
    column writes only the entries its rows use (its vocabulary holds one
    entry per row of the batches it came from)."""
    codes = np.ascontiguousarray(vals.codes, dtype=np.int32)
    if dtype.is_nested:
        used, inv = np.unique(np.clip(codes, 0, len(vals.vocab) - 1), return_inverse=True)
        vals = DictCodes(inv.reshape(-1).astype(np.int32), vals.vocab[used])
        codes = vals.codes
    vbytes = None
    if valid is not None and not valid.all():
        valid = np.ascontiguousarray(valid, dtype=bool)
        vbytes = np.packbits(valid, bitorder="little").tobytes()
        codes = codes * valid
    denc, dpayload = encode_int_plane(codes)
    dict_ipc = arrow_column_stream(vals.vocab, dtype)
    return ENC_DICT, vbytes, (struct.pack("<I", len(dict_ipc)) + dict_ipc
                              + struct.pack("<BI", denc, len(dpayload)) + dpayload)


def decode_dict(body: bytes, valid: np.ndarray | None, nrows: int,
                dtype: T.DataType) -> tuple[DictCodes, np.ndarray | None]:
    """(plane, validity) of an ENC_DICT column. A row whose code points at
    a NULL entry of a nested vocabulary (the JAX writer's keeps its NULL
    rows' entries) is NULL, its entry an ``empty_entry`` filler."""
    (dlen,) = struct.unpack_from("<I", body, 0)
    vocab = read_arrow_column_stream(body[4 : 4 + dlen], dtype)
    denc, dplen = struct.unpack_from("<BI", body, 4 + dlen)
    start = 4 + dlen + 5
    codes = decode_int_plane(denc, body[start : start + dplen], nrows, np.dtype(np.int32))
    if len(vocab) == 0:
        vocab = empty_dict(dtype)
    null_entry = np.equal(vocab, None)
    if null_entry.any():
        hit = null_entry[np.clip(codes, 0, len(vocab) - 1)]
        valid = ~hit if valid is None else valid & ~hit
        vocab = object_array([e if e is not None else empty_entry(dtype) for e in vocab])
    return DictCodes(codes, vocab), valid


def _dec128_halves(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) int64 halves of 128-bit two's-complement integers (an
    object array of Python ints)."""
    lo = np.array([(int(x) & 0xFFFFFFFFFFFFFFFF) for x in u], dtype=np.uint64).view(np.int64)
    hi = np.array([int(x) >> 64 for x in u], dtype=np.int64)
    return lo, hi


def _encode_dec128_column(vals, valid: np.ndarray | None,
                          dtype: T.DataType) -> tuple[int, bytes | None, bytes]:
    """ENC_DEC128: lo then hi int64 sub-planes, each ``u8 enc | u32 len |
    payload``, NULL lanes zeroed (``format.py:669-681``)."""
    if dtype.is_wide_decimal:
        codes = np.clip(np.asarray(vals.codes, dtype=np.int64), 0, max(len(vals.vocab) - 1, 0))
        u = np.empty(max(len(vals.vocab), 1), dtype=object)
        u[:] = [T.unscaled_int(e, dtype.scale) if e is not None else 0 for e in vals.vocab] or [0]
        tlo, thi = _dec128_halves(u)
        lo, hi = tlo[codes], thi[codes]
    else:
        lo = np.ascontiguousarray(vals, dtype=np.int64)
        hi = lo >> 63
    if valid is not None and valid.all():
        valid = None
    vbytes = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=bool)
        vbytes = np.packbits(valid, bitorder="little").tobytes()
        lo, hi = lo * valid, hi * valid
    le, lp = encode_int_plane(np.ascontiguousarray(lo))
    he, hp = encode_int_plane(np.ascontiguousarray(hi))
    return ENC_DEC128, vbytes, (struct.pack("<BI", le, len(lp)) + lp
                                + struct.pack("<BI", he, len(hp)) + hp)


def decode_dec128(body: bytes, valid: np.ndarray | None, nrows: int, dtype: T.DataType):
    """(plane, validity) of an ENC_DEC128 column: a decimal64 keeps the lanes
    that fit int64 (the others turn NULL), a wide decimal becomes codes into
    its distinct values (first-occurrence order)."""
    if dtype.kind != T.TypeKind.DECIMAL:
        raise ValueError(f"dec128 encoding on a {dtype} column")
    le, lplen = struct.unpack_from("<BI", body, 0)
    lo = decode_int_plane(le, body[5 : 5 + lplen], nrows, np.dtype(np.int64))
    he, hplen = struct.unpack_from("<BI", body, 5 + lplen)
    hi = decode_int_plane(he, body[10 + lplen : 10 + lplen + hplen], nrows, np.dtype(np.int64))
    if not dtype.is_wide_decimal:
        fits = hi == (lo >> 63)
        vals = np.where(fits, lo, np.int64(0))
        return vals, (fits if valid is None else valid & fits)
    pairs = np.stack([hi, lo], axis=1)
    uniq, first, inv = np.unique(pairs, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    vocab = np.empty(max(len(uniq), 1), dtype=object)
    vocab[:] = [T.decimal_from_unscaled((int(h) << 64) | (int(l) & 0xFFFFFFFFFFFFFFFF),
                                        dtype.scale) for h, l in uniq[order]] or [
        T.decimal_from_unscaled(0, dtype.scale)]
    return DictCodes(rank[inv.reshape(-1)], vocab), valid


def _encode_arrow_column(vals: DictCodes, valid: np.ndarray | None, dtype: T.DataType,
                         codec: str | None) -> tuple[int, bytes | None, bytes]:
    """ENC_ARROW: the column's values (vocabulary entries by code, NULL rows
    NULL) as a self-describing single-column Arrow IPC stream under the
    codec; no validity section (``format.py:782``)."""
    vocab = vals.vocab
    ent = vocab[np.clip(np.asarray(vals.codes, np.int64), 0, max(len(vocab) - 1, 0))] \
        if len(vocab) else object_array([None] * len(vals))
    col = ent.tolist()
    if valid is not None:
        for i in np.flatnonzero(~valid).tolist():
            col[i] = None
    schema = T.Schema((T.Field("", dtype, True),))
    hb = HostBatch(schema, len(col), (array_from_pylist(col, dtype),))
    return ENC_ARROW, None, arrow_ipc.write_stream([hb], codec=codec)


def decode_arrow(body: bytes, nrows: int, dtype: T.DataType):
    """(plane, validity) of an ENC_ARROW column (a single-column Arrow IPC
    stream, compressed or not, from either package's writer)."""
    n, cols = _host_columns(arrow_ipc.read_stream(body), T.Schema((T.Field("", dtype, True),)))
    if n != nrows:
        raise ValueError(f"arrow column holds {n} rows, the block {nrows}")
    return cols[0]


def encode_column(vals, valid: np.ndarray | None, dtype: T.DataType, codec: str | None = None,
                  dict_max: int | None = None) -> tuple[int, bytes | None, bytes]:
    """One column's (enc, packed validity or None, payload), with the JAX
    writer's rules (``format.py:_encode_column``). ``vals`` is a numpy
    plane, or a ``DictCodes`` for a dictionary-encoded column; a vocabulary
    past ``dict_max`` entries (a nested one's used entries) is ENC_ARROW."""
    if dtype.kind == T.TypeKind.DECIMAL:
        return _encode_dec128_column(vals, valid, dtype)
    if dtype.is_dict_encoded:
        if dict_max is not None and len(vals.vocab) > dict_max:
            used = np.unique(np.clip(vals.codes, 0, len(vals.vocab) - 1)) if dtype.is_nested \
                else vals.vocab
            if len(used) > dict_max:
                return _encode_arrow_column(vals, valid, dtype, codec)
        return _encode_dict_column(vals, valid, dtype)
    kind = plane_kind(dtype)
    n = len(vals)
    vals = np.ascontiguousarray(vals, dtype=dtype.numpy_dtype())
    if valid is not None and valid.all():
        valid = None
    vbytes = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=bool)
        vbytes = np.packbits(valid, bitorder="little").tobytes()
        if kind != "bool" and 2 * (n - int(np.count_nonzero(valid))) >= n:
            # null-dominated plane: only the valid lanes' values
            sub = np.ascontiguousarray(vals[valid])
            se, sp = encode_int_plane(sub) if kind == "int" else encode_float_plane(sub, codec)
            return ENC_SPARSE, vbytes, struct.pack("<IBI", len(sub), se, len(sp)) + sp
    if kind == "bool":
        bits = vals if valid is None else (vals & valid)
        return ENC_PACKBITS, vbytes, np.packbits(bits, bitorder="little").tobytes()
    if valid is not None:  # null lanes zeroed: deterministic bytes
        vals = vals * valid if kind == "int" else np.where(valid, vals, vals.dtype.type(0))
    if kind == "float":
        enc, payload = encode_float_plane(vals, codec)
        return enc, vbytes, payload
    enc, payload = encode_int_plane(vals)
    if enc == ENC_RAW:
        comp = _codec_plane(codec, payload)
        if comp is not None:
            return ENC_CODEC, vbytes, comp
    return enc, vbytes, payload


def decode_column(enc: int, body: bytes, valid: np.ndarray | None, nrows: int,
                  dtype: T.DataType):
    """A fixed-width column's host plane (numpy values)."""
    if enc in (ENC_DICT, ENC_DEC128, ENC_ARROW):
        raise ValueError(f"a {ENC_NAMES[enc]} column decodes through decode_{ENC_NAMES[enc]} "
                         "(it sets validity)")
    kind = plane_kind(dtype)
    npdt = dtype.numpy_dtype()
    if enc == ENC_PACKBITS:
        return np.unpackbits(np.frombuffer(body, np.uint8), count=nrows,
                             bitorder="little").astype(bool)
    if enc == ENC_SPARSE:
        if valid is None:
            raise ValueError("sparse plane without validity")
        nvalid, se, slen = struct.unpack_from("<IBI", body, 0)
        sub_body = body[9 : 9 + slen]
        if kind == "int":
            sub = decode_int_plane(se, sub_body, nvalid, npdt)
        elif kind == "float":
            sub = decode_float_plane(se, sub_body, nvalid, npdt)
        else:
            raise ValueError(f"sparse on a {dtype} column")
        out = np.zeros(nrows, dtype=npdt)
        out[valid] = sub
        return out
    if kind == "int":
        return decode_int_plane(enc, body, nrows, npdt)
    if kind == "float":
        return decode_float_plane(enc, body, nrows, npdt)
    raise ValueError(f"encoding {enc} on a {dtype} column")


# ---------------------------------------------------------------------------
# the schema section and the vocabularies: Arrow IPC without pyarrow
# (columnar/arrow_ipc.py)
# ---------------------------------------------------------------------------


def arrow_schema_message(schema: T.Schema) -> bytes:
    """The IPC stream ``pa.ipc.new_stream(sink, schema).close()`` would
    write for the schema (one schema message, then end-of-stream). Each
    dictionary-encoded string/binary field carries a DictionaryEncoding
    (ids 0, 1, ... in field order, int32 indices), as pyarrow writes a
    dictionary-typed schema (a nested field's value type with its
    children); a wide decimal is plain decimal128 (its column is dec128
    planes)."""
    ids = {}
    for i, f in enumerate(schema):
        if f.dtype.is_string_like or f.dtype.is_nested:
            ids[i] = len(ids)
    return arrow_ipc.schema_message(schema, ids) + arrow_ipc.EOS


def arrow_column_stream(vocab: np.ndarray, dtype: T.DataType) -> bytes:
    """A one-column Arrow IPC stream of a string, binary or nested
    vocabulary (no NULLs): schema, one record batch, end-of-stream."""
    col = array_from_pylist(list(vocab), dtype)
    schema = T.Schema((T.Field("", dtype, False),))
    return arrow_ipc.write_stream([HostBatch(schema, len(vocab), (col,))])


def read_arrow_column_stream(payload: bytes, dtype: T.DataType) -> np.ndarray:
    """The values of a one-column string/binary (or decimal128: Decimals at
    the column's scale, or nested) Arrow IPC stream (as
    ``arrow_column_stream`` or pyarrow writes it) as a numpy object array.
    Compressed bodies raise, and so do NULL values, except in a nested
    vocabulary (None entries: the JAX writer's holds its NULL rows')."""
    for hb in arrow_ipc.iter_stream(payload):
        (col,) = hb.columns
        if dtype.is_nested:
            return object_array(col.to_pylist())
        if col.nulls():
            raise ValueError("a dictionary vocabulary holds NULL values")
        out = np.empty(hb.length, dtype=object)
        out[:] = col.to_pylist()
        return out
    raise ValueError("Arrow IPC stream without a record batch")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def host_planes(batch, metrics=None) -> tuple[int, list]:
    """(live rows, [(values, validity or None)]) of a device batch
    (``Batch.live_host_planes``), a dictionary-encoded column as
    ``DictCodes`` into its vocabulary: what ``encode_block`` takes."""
    n, planes = batch.live_host_planes(metrics)
    cols = []
    for i, (f, (vals, valid)) in enumerate(zip(batch.schema, planes)):
        if f.dtype.is_dict_encoded:
            vals = DictCodes(vals, batch.dicts[i])
        cols.append((vals, None if valid.all() else valid))
    return n, cols


def encode_block(schema: T.Schema, cols: list, metrics=None, codec: str | None = None,
                 dict_max: int | None = None) -> bytes:
    """One length-prefixed v2 block from host planes ``cols[i] = (values,
    validity or None)``, all of one length, with the general ``codec``
    (``fallback_codec``) and the ``dict_max`` of ENC_DICT. Deterministic:
    the same rows give the same bytes."""
    nrows = len(cols[0][0]) if cols else 0
    sbytes = arrow_schema_message(schema)
    out = [V2_MAGIC, struct.pack("<BBHII", 2, 0, len(schema), nrows, len(sbytes)), sbytes]
    for f, (vals, valid) in zip(schema, cols):
        enc, vbytes, payload = encode_column(vals, valid, f.dtype, codec, dict_max)
        if metrics is not None:
            metrics.add(f"shuffle_enc_{ENC_NAMES[enc]}", 1)
        out.append(struct.pack("<BB", enc, 1 if vbytes is not None else 0))
        if vbytes is not None:
            out.append(struct.pack("<I", len(vbytes)))
            out.append(vbytes)
        out.append(struct.pack("<I", len(payload)))
        out.append(payload)
    body = b"".join(out)
    return struct.pack("<Q", len(body)) + body


def is_v2_payload(payload: bytes) -> bool:
    return payload[:4] == V2_MAGIC


def encode_v1_block(schema: T.Schema, cols: list, codec: str | None = None) -> bytes:
    """One length-prefixed v1 block (``format.py:encode_block``): the host
    planes as one Arrow IPC stream, each body buffer compressed with
    ``codec`` (``v1_codec``), written by ``columnar/arrow_ipc.py``."""
    nrows = len(cols[0][0]) if cols else 0
    arrays = []
    for f, (vals, valid) in zip(schema, cols):
        if isinstance(vals, DictCodes):
            d = vals.vocab
            vals = d[np.clip(np.asarray(vals.codes, np.int64), 0, max(len(d) - 1, 0))] \
                if len(d) else object_array([None] * len(vals))
        arrays.append(array_from_numpy(vals, f.dtype, valid))
    payload = arrow_ipc.write_stream([HostBatch(schema, nrows, tuple(arrays))], codec=codec)
    return struct.pack("<Q", len(payload)) + payload


def _decode_v1(payload: bytes, schema: T.Schema) -> tuple[int, list]:
    """A v1 block: an Arrow IPC stream (``columnar/arrow_ipc.py``; a
    compressed body through the codecs), its record batches' planes in the
    port's host form."""
    return _host_columns(arrow_ipc.read_stream(payload), schema)


def _host_columns(batches: list, schema: T.Schema) -> tuple[int, list]:
    """(rows, [(values, validity or None)]) of host Arrow batches in the
    port's host plane form, column types from ``schema``."""
    from auron_tpu_torch.columnar.batch import host_plane

    parts: list[list] = [[] for _ in schema]
    for hb in batches:
        if len(hb.columns) != len(schema):
            raise ValueError(f"block has {len(hb.columns)} columns, the plan schema "
                             f"{len(schema)}")
        for i, (f, arr) in enumerate(zip(schema, hb.columns)):
            plane, _, validity, vocab = host_plane(arr, f.dtype)
            if plane is None:  # the NULL type
                plane, validity = np.zeros(hb.length, np.int8), np.zeros(hb.length, bool)
            elif isinstance(validity, tuple):
                packed, off = validity
                validity = np.unpackbits(packed, bitorder="little")[off: off + hb.length] \
                    .astype(bool)
            if vocab is not None:
                plane = DictCodes(np.asarray(plane, np.int32), vocab)
            elif validity is not None:
                plane = np.where(validity, plane, plane.dtype.type(0))
            parts[i].append((plane, np.ones(hb.length, bool) if validity is None else validity))
    nrows = sum(hb.length for hb in batches)
    cols = []
    for f, ps in zip(schema, parts):
        if not ps:
            cols.append((np.zeros(0, f.dtype.numpy_dtype()), None))
            continue
        vals = (DictCodes.concat([p for p, _ in ps], f.dtype.is_nested)
                if isinstance(ps[0][0], DictCodes)
                else np.concatenate([p for p, _ in ps]))
        valid = np.concatenate([m for _, m in ps])
        cols.append((vals, None if valid.all() else valid))
    return nrows, cols


def decode_block(payload: bytes, schema: T.Schema) -> tuple[int, list]:
    """(nrows, [(values, validity or None)]) of one payload, column types
    from ``schema``: a v2 block, or a v1 block (an Arrow IPC stream, its
    body compressed or not). Corrupt blocks raise ValueError."""
    if not is_v2_payload(payload):
        return _decode_v1(payload, schema)
    try:
        ver, _, ncols, nrows, slen = struct.unpack_from("<BBHII", payload, 4)
        if ver != 2:
            raise ValueError(f"unsupported block version {ver}")
        if ncols != len(schema):
            raise ValueError(f"block has {ncols} columns, the plan schema {len(schema)}")
        pos = 16 + slen  # the reader takes its types from the plan schema
        if pos > len(payload):
            raise ValueError("schema section overruns the block")
        cols = []
        for f in schema:
            enc, hasv = struct.unpack_from("<BB", payload, pos)
            pos += 2
            valid = None
            if hasv:
                (vlen,) = struct.unpack_from("<I", payload, pos)
                pos += 4
                vbits = np.frombuffer(payload, np.uint8, count=vlen, offset=pos)
                valid = np.unpackbits(vbits, count=nrows, bitorder="little").astype(bool)
                pos += vlen
            (plen,) = struct.unpack_from("<I", payload, pos)
            pos += 4
            body = payload[pos : pos + plen]
            if len(body) != plen:
                raise ValueError("column payload truncated")
            pos += plen
            if enc == ENC_DEC128:
                cols.append(decode_dec128(body, valid, nrows, f.dtype))
            elif enc == ENC_DICT:
                cols.append(decode_dict(body, valid, nrows, f.dtype))
            elif enc == ENC_ARROW:
                cols.append(decode_arrow(body, nrows, f.dtype))
            else:
                cols.append((decode_column(enc, body, valid, nrows, f.dtype), valid))
        return nrows, cols
    except (struct.error, IndexError, KeyError) as e:
        raise ValueError(f"corrupt v2 shuffle block: {e!r}") from e
