"""Byte-payload compression helpers.

JAX counterpart of the reference's zstd wrapper
(/root/reference/include/albatross/src/utils/compress.hpp, exercised by
tests/test_compression.cc): same three-call surface — ``compress``,
``decompress`` (raises on garbage), ``maybe_decompress`` (returns a success
flag) — backed by zlib, which is what the checkpoint writer already uses
for array payloads.  Level range is clamped to zlib's 0..9 so the
reference's 0..20 zstd levels remain accepted arguments.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple, Union

DEFAULT_LEVEL = 3


def _to_bytes(payload: Union[bytes, bytearray, str]) -> bytes:
    if isinstance(payload, str):
        return payload.encode("utf-8")
    return bytes(payload)


def compress(payload: Union[bytes, bytearray, str], level: int = DEFAULT_LEVEL) -> bytes:
    """Compress a string/bytes payload (compress.hpp compress)."""
    level = max(0, min(9, int(level)))
    return zlib.compress(_to_bytes(payload), level)


def decompress(payload: bytes, as_text: bool = False) -> Union[bytes, str]:
    """Decompress; raises ValueError on empty/invalid input
    (the reference asserts 'error determining' on both)."""
    if not payload:
        raise ValueError("error determining decompressed size: empty input")
    try:
        out = zlib.decompress(bytes(payload))
    except zlib.error as exc:
        raise ValueError(f"error determining decompressed size: {exc}") from exc
    return out.decode("utf-8") if as_text else out


def maybe_decompress(
    payload: bytes, as_text: bool = False
) -> Tuple[bool, Optional[Union[bytes, str]]]:
    """Non-throwing decompress: (ok, output-or-None)
    (compress.hpp maybe_decompress)."""
    try:
        return True, decompress(payload, as_text=as_text)
    except ValueError:
        return False, None
