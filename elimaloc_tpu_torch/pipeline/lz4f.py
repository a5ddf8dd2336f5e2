"""Pure-Python LZ4 frame/block decompression for rosbag ``lz4`` chunks (a
copy of ``elimaloc_tpu.pipeline.lz4f``).

rosbag's ``lz4`` chunk compression is roslz4, which writes the standard
LZ4 Frame format (magic ``0x184D2204``; frame descriptor; a sequence of
size-prefixed LZ4 blocks; end mark). The environment has no lz4 binding
and none may be installed, so this implements the subset roslz4 emits:

  * frame descriptor v01, with/without block independence, content size,
    and checksum flags (xxHash checksums are SKIPPED, not verified — this
    is an ingest path, and the bag's own record framing already bounds
    corruption blast radius);
  * raw (high-bit) and compressed blocks; block-DEPENDENT streams work
    because decoding appends into one contiguous output buffer, so match
    offsets may reach into earlier blocks' output.

Format reference: lz4 Frame spec v1.6.x (github.com/lz4/lz4). Throughput
is Python-loop bound (~MB/s): fine for ingest, not for a hot path.
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204


def block_decompress(src: bytes, dst: bytearray) -> None:
    """LZ4 *block* format: append the decompressed bytes onto ``dst``
    (which may already hold earlier blocks — match offsets can reference
    it)."""
    i = 0
    n = len(src)
    base = len(dst)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            dst += src[i:i + lit]
            i += lit
        if i >= n:
            break  # final sequence carries literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset before output start")
        if offset >= mlen:
            dst += dst[start:start + mlen]
        else:  # overlapping copy replicates the last `offset` bytes
            for k in range(mlen):
                dst.append(dst[start + k])
    if len(dst) == base and n:
        raise ValueError("corrupt LZ4 block: no output")


def frame_decompress(buf: bytes) -> bytes:
    """Decompress one LZ4 frame (roslz4 chunk payload)."""
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an LZ4 frame (magic {magic:#x})")
    flg = buf[4]
    version = flg >> 6
    if version != 1:
        raise ValueError(f"unsupported LZ4 frame version {version}")
    block_checksum = bool(flg & 0x10)
    content_size = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    off = 6  # magic + FLG + BD
    if content_size:
        off += 8
    off += 1  # header checksum byte (not verified)

    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", buf, off)
        off += 4
        if bsize == 0:  # EndMark
            break
        raw = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = buf[off:off + bsize]
        off += bsize
        if block_checksum:
            off += 4
        if raw:
            out += block
        else:
            block_decompress(block, out)
    if content_checksum:
        off += 4
    return bytes(out)
