"""The general codecs, lz4 (frame format) and zstd, through pyarrow's
``pa.Codec`` (the reference's codec layer, ``exec/shuffle/format.py``):
pyarrow is imported inside each function (``utils/arrowlib.pyarrow``: on
a thread that outlives the task pumps), so a module of the port imports
nothing of it until a compressed byte is written or read.

Used by the shuffle block format (ENC_CODEC planes, ENC_ARROW columns, v1
blocks) and by ``columnar/arrow_ipc.py`` for compressed IPC bodies.
"""

from __future__ import annotations

from auron_tpu_torch.utils.arrowlib import pyarrow

#: the shuffle format's codec ids (ENC_CODEC payloads)
CODEC_IDS = {"lz4": 1, "zstd": 2}
CODEC_BY_ID = {v: k for k, v in CODEC_IDS.items()}


def available(name: str) -> bool:
    """Whether this process can compress with ``name``: pyarrow imports
    and its build has the codec. Anything else, a failed import included,
    is unavailable."""
    if name not in CODEC_IDS:
        return False
    try:
        return bool(pyarrow().Codec.is_available(name))
    except Exception:  # noqa: BLE001 — an unprobeable codec is unavailable
        return False


def compress(name: str, raw) -> bytes:
    return pyarrow().Codec(name).compress(raw, asbytes=True)


def decompress(name: str, data, size: int) -> bytes:
    return pyarrow().Codec(name).decompress(data, decompressed_size=size, asbytes=True)
