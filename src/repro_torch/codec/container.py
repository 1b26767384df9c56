"""Versioned rANS bitstream container — per-tile chunks, partial decode.

Layout (all little-endian)::

    header   "RTC1" | u8 version | u8 mode | u8 bits | u8 prob_bits |
             u16 lanes | u16 neighbor_dist | u32 n_chunks | u32 table_len |
             u32 crc32(header fields above)
    tables   zlib(table blob)   # static mode: n_chunks tables of
                                # (1 << bits) uint16 frequencies each;
                                # adaptive mode: empty (nothing transmitted)
    chunk[i] u32 count | u32 n_words | u32 crc32(count|n_words|states|words)
             | lanes * u32 lane states | n_words * u16 rANS words

One chunk per tile (= channel plane of the BaF residual tensor, matching
``core/tiling.py``'s channel tiles). Chunk boundaries are computable from
the fixed-size chunk headers alone, so a decoder can skip straight to any
subset of tiles (:meth:`RansContainer.decode_channels`) without touching the
other payloads — the table blob is the only shared section.

Every structural violation raises :class:`CorruptStream` with a distinct
message: bad magic, unknown version/mode, truncated header, truncated table
blob, truncated chunk, trailing garbage. Bit corruption is caught in depth:
the header carries its own CRC32, the table blob rides zlib's adler32, each
chunk is CRC32'd (verified on decode of that chunk), and the rANS coder
additionally checks that every lane state returns to its initial value.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.codec import context as ctx
from repro_torch.codec.rans import RANS_L, CorruptStream, RansTable, rans_decode

MAGIC = b"RTC1"
VERSION = 1
MODE_STATIC = 0
MODE_ADAPTIVE = 1

_HEADER = struct.Struct("<4sBBBBHHII")
_HEADER_CRC = struct.Struct("<I")
_CHUNK_HEADER = struct.Struct("<III")     # count | n_words | crc32


@dataclass(frozen=True)
class ContainerHeader:
    mode: int
    bits: int
    prob_bits: int
    lanes: int
    neighbor_dist: int
    n_chunks: int


def pack_container(*, mode: int, bits: int, prob_bits: int, lanes: int,
                   neighbor_dist: int,
                   tables: list[np.ndarray] | None,
                   chunks: list[tuple[int, np.ndarray, bytes]]) -> bytes:
    """Assemble the wire blob.

    tables : per-chunk frequency arrays (static mode) or None (adaptive)
    chunks : [(symbol count, lane states (lanes,) uint32, word bytes)]
    """
    if tables is not None and len(tables) != len(chunks):
        raise ValueError(f"{len(tables)} tables for {len(chunks)} chunks")
    table_blob = b""
    if tables is not None and tables:
        raw = np.concatenate([t.astype("<u2") for t in tables]).tobytes()
        table_blob = zlib.compress(raw, 9)
    hdr = _HEADER.pack(MAGIC, VERSION, mode, bits, prob_bits, lanes,
                       neighbor_dist, len(chunks), len(table_blob))
    out = [hdr, _HEADER_CRC.pack(zlib.crc32(hdr)), table_blob]
    for count, states, words in chunks:
        if len(words) % 2:
            raise ValueError("word stream must be whole 16-bit words")
        body = (struct.pack("<II", count, len(words) // 2)
                + np.ascontiguousarray(states, "<u4").tobytes() + words)
        out.append(_CHUNK_HEADER.pack(count, len(words) // 2,
                                      zlib.crc32(body)))
        out.append(body[8:])                      # states + words
    return b"".join(out)


class RansContainer:
    """Parsed, validated view over a container blob; decodes lazily."""

    def __init__(self, header: ContainerHeader, tables: list[np.ndarray],
                 chunk_meta: list[tuple[int, int, int]], blob: bytes):
        self.header = header
        self._tables = tables
        self._chunk_meta = chunk_meta      # (count, states_off, words_len)
        self._blob = blob

    @classmethod
    def parse(cls, blob: bytes) -> "RansContainer":
        hdr_size = _HEADER.size + _HEADER_CRC.size
        if len(blob) < hdr_size:
            raise CorruptStream(
                f"truncated container header: {len(blob)} bytes, "
                f"need {hdr_size}")
        (magic, version, mode, bits, prob_bits, lanes, neighbor_dist,
         n_chunks, table_len) = _HEADER.unpack_from(blob, 0)
        if magic != MAGIC:
            raise CorruptStream(f"bad container magic {magic!r}")
        if version != VERSION:
            raise CorruptStream(f"unsupported container version {version}")
        (hdr_crc,) = _HEADER_CRC.unpack_from(blob, _HEADER.size)
        if hdr_crc != zlib.crc32(blob[:_HEADER.size]):
            raise CorruptStream("container header CRC mismatch")
        if mode not in (MODE_STATIC, MODE_ADAPTIVE):
            raise CorruptStream(f"unknown container mode {mode}")
        if not 1 <= bits <= 16 or lanes < 1:
            raise CorruptStream(
                f"implausible container geometry: bits={bits} lanes={lanes}")
        off = hdr_size
        if off + table_len > len(blob):
            raise CorruptStream(
                f"truncated table blob: header claims {table_len} bytes, "
                f"{len(blob) - off} remain")
        tables: list[np.ndarray] = []
        if mode == MODE_STATIC and n_chunks:
            try:
                raw = zlib.decompress(blob[off:off + table_len])
            except zlib.error as e:
                raise CorruptStream(f"undecodable table blob: {e}") from e
            nsym = 1 << bits
            if len(raw) != n_chunks * nsym * 2:
                raise CorruptStream(
                    f"table blob holds {len(raw)} bytes, expected "
                    f"{n_chunks * nsym * 2} ({n_chunks} tables of "
                    f"{nsym} uint16)")
            flat = np.frombuffer(raw, "<u2").reshape(n_chunks, nsym)
            tables = [flat[i] for i in range(n_chunks)]
        elif table_len and mode == MODE_ADAPTIVE:
            raise CorruptStream("adaptive container carries a table blob")
        off += table_len
        chunk_meta = []
        for i in range(n_chunks):
            if off + _CHUNK_HEADER.size > len(blob):
                raise CorruptStream(
                    f"truncated chunk {i} header at byte {off}")
            count, n_words, crc = _CHUNK_HEADER.unpack_from(blob, off)
            off += _CHUNK_HEADER.size
            states_off = off
            need = 4 * lanes + 2 * n_words
            if off + need > len(blob):
                raise CorruptStream(
                    f"truncated chunk {i}: needs {need} bytes at byte "
                    f"{off}, {len(blob) - off} remain")
            chunk_meta.append((count, states_off, 2 * n_words, crc))
            off += need
        if off != len(blob):
            raise CorruptStream(
                f"{len(blob) - off} bytes of trailing garbage after "
                f"chunk {n_chunks - 1 if n_chunks else 'header'}")
        header = ContainerHeader(mode=mode, bits=bits, prob_bits=prob_bits,
                                 lanes=lanes, neighbor_dist=neighbor_dist,
                                 n_chunks=n_chunks)
        return cls(header, tables, chunk_meta, blob)

    # -- decode -------------------------------------------------------------
    def chunk_count(self, i: int) -> int:
        return self._chunk_meta[i][0]

    def chunk_parts(self, i: int) -> tuple[int, np.ndarray, bytes]:
        """CRC-verified raw parts of chunk ``i``: (count, lane states, words).

        The shared extraction step behind :meth:`decode_chunk` and the
        cross-container batched decoder (repro_torch.codec.batch) — every consumer
        gets the same integrity checks before touching a payload byte."""
        h = self.header
        count, states_off, words_len, crc = self._chunk_meta[i]
        end = states_off + 4 * h.lanes + words_len
        body = (struct.pack("<II", count, words_len // 2)
                + self._blob[states_off:end])
        if crc != zlib.crc32(body):
            raise CorruptStream(f"chunk {i} CRC mismatch (corrupt payload)")
        states = np.frombuffer(
            self._blob, "<u4", count=h.lanes, offset=states_off)
        words = self._blob[states_off + 4 * h.lanes:end]
        if count == 0:
            if words_len:
                raise CorruptStream(
                    f"chunk {i}: nonempty word stream for an empty chunk")
            if not bool(np.all(states == RANS_L)):
                raise CorruptStream(
                    f"chunk {i}: empty chunk with non-initial lane states")
        return count, states, words

    def chunk_table(self, i: int) -> np.ndarray | None:
        """Static-mode frequency table of chunk ``i`` (None when adaptive)."""
        return self._tables[i] if self.header.mode == MODE_STATIC else None

    def decode_chunk(self, i: int) -> np.ndarray:
        """Decode tile ``i`` alone; other chunks are never touched."""
        h = self.header
        count, states, words = self.chunk_parts(i)
        if count == 0:
            return np.empty(0, np.uint32)
        if h.mode == MODE_STATIC:
            table = RansTable(freqs=self._tables[i].astype(np.uint32),
                              prob_bits=h.prob_bits)
            return rans_decode(states, words, count, table, h.lanes)
        return ctx.decode_ctx(states, words, count, h.bits, h.lanes,
                              h.neighbor_dist)

    def decode_channels(self, indices) -> np.ndarray:
        """Partial decode: (len(indices), count) for the requested tiles."""
        rows = [self.decode_chunk(int(i)) for i in indices]
        return np.stack(rows) if rows else np.empty((0, 0), np.uint32)

    def decode_all(self) -> np.ndarray:
        return self.decode_channels(range(self.header.n_chunks))
