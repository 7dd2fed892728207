"""An independent minimal OpenEXR scanline reader, written from the
OpenEXR 2.0 specification (magic and version, the attribute list, the
channel list, the scanline offset table, NO_COMPRESSION/ZIPS/ZIP block
framing and the zip byte-interleave and delta predictor), for the
port's tests and ``chip_smoke.py``. It imports neither jax nor either
package: a writer bug in the header or the block framing cannot cancel
out here, because the reader walks the file by its own offset arithmetic
and cross-checks the written offset table.

``read_exr(path)`` returns ``(planes, channels, (w, h))``: each channel's
``[H, W]`` float32 plane by name, the ``(name, pixel type)`` list in file
order, and the size.
"""

import struct
import zlib

import numpy as np


def unzip_block(data: bytes, raw_size: int) -> bytes:
    """Inverse of the EXR zip transform (spec/ImfZip.cpp): deflate,
    then undo the delta predictor, then un-interleave. A block whose
    stored size equals the raw size is stored uncompressed."""
    if len(data) == raw_size:
        return data
    t = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    assert len(t) == raw_size
    # predictor forward was d[i] = t[i] - t[i-1] + 384 (mod 256)
    e = t.copy()
    e[1:] -= 128 + 256
    t = (np.cumsum(e) % 256).astype(np.uint8)
    half = (raw_size + 1) // 2
    out = np.empty(raw_size, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(path):
    """Independent minimal OpenEXR scanline reader (spec-derived)."""
    raw = open(path, "rb").read()
    magic, version = struct.unpack_from("<ii", raw, 0)
    assert magic == 20000630, hex(magic)
    assert version == 2, version  # single-part scanline, short names
    pos = 8

    def cstr(p):
        end = raw.index(b"\0", p)
        return raw[p:end], end + 1

    attrs = {}
    while True:
        if raw[pos:pos + 1] == b"\0":  # end of header
            pos += 1
            break
        name, pos = cstr(pos)
        type_, pos = cstr(pos)
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        attrs[name] = (type_, raw[pos:pos + size])
        pos += size

    # channel list
    chtype, chdata = attrs[b"channels"]
    assert chtype == b"chlist"
    channels = []
    cpos = 0
    while chdata[cpos:cpos + 1] != b"\0":
        cend = chdata.index(b"\0", cpos)
        cname = chdata[cpos:cend]
        ptype, _pl, _r0, _r1, _r2, xs, ys = struct.unpack_from(
            "<iBBBBii", chdata, cend + 1
        )
        assert (xs, ys) == (1, 1)
        channels.append((cname, ptype))
        cpos = cend + 1 + 16
    assert chdata[cpos:] == b"\0"
    assert [n for n, _ in channels] == sorted(n for n, _ in channels)

    _, dw = attrs[b"dataWindow"]
    x0, y0, x1, y1 = struct.unpack("<4i", dw)
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp_id = attrs[b"compression"][1][0]
    lines_per_block = {0: 1, 2: 1, 3: 16}[comp_id]
    assert attrs[b"lineOrder"][1] == b"\0"  # increasing Y

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from("<%dQ" % n_blocks, raw, pos)
    pos += 8 * n_blocks

    dtypes = {1: np.dtype("<f2"), 2: np.dtype("<f4")}
    row_bytes = sum(dtypes[pt].itemsize for _, pt in channels) * w
    planes = {name: np.empty((h, w), np.float32) for name, _ in channels}
    for i, off in enumerate(offsets):
        # the first block must start right after the offset table, and
        # blocks must be contiguous — cross-checks the writer's offsets
        assert off == (pos if i == 0 else offsets[i - 1] + prev_size)
        y, size = struct.unpack_from("<ii", raw, off)
        assert y == i * lines_per_block
        y_hi = min(y + lines_per_block, h)
        raw_size = (y_hi - y) * row_bytes
        data = unzip_block(raw[off + 8:off + 8 + size], raw_size)
        p = 0
        for yy in range(y, y_hi):
            for name, ptype in channels:
                dt = dtypes[ptype]
                row = np.frombuffer(data, dt, count=w, offset=p)
                planes[name][yy] = row.astype(np.float32)
                p += w * dt.itemsize
        assert p == raw_size
        prev_size = 8 + size
    assert offsets[-1] + prev_size == len(raw)  # no trailing garbage
    return planes, channels, (w, h)
