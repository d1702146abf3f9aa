"""Host-side scanner-ingest codec throughput (no accelerator required).

Times every DICOM transfer syntax's encode + decode on synthetic MR-like
slices, native C++ path vs the pure-Python oracle. Prints one JSON object;
numbers land in docs/ARCHITECTURE.md's codec section.

    python tools/codec_bench.py [--size 256] [--reps 5]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _mr_slice(size: int, rng) -> np.ndarray:
    yy, xx = np.mgrid[:size, :size]
    img = (
        800
        + 420 * np.sin(yy / 23.0) * np.cos(xx / 17.0)
        + 300 * np.exp(-((yy - size / 2) ** 2 + (xx - size / 2) ** 2) / (size * 4.0))
        + rng.normal(0, 25, (size, size))
    )
    return np.clip(img, 0, 4095).astype(np.uint16)


def _time(fn, reps):
    fn()  # warm (native build, LUTs)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from mamri_tpu import native
    from mamri_tpu.perception import jpeg2000, jpegll, jpegls
    from mamri_tpu.perception.dicom import _packbits_encode, _rle_encode_frame, _rle_decode_frame

    rng = np.random.default_rng(7)
    img = _mr_slice(args.size, rng)
    npix = img.size
    out = {"size": f"{args.size}^2", "native_available": native.available(), "codecs": {}}

    def report(name, enc_fn, dec_fn, nbytes, lossless=True):
        enc_ms = _time(enc_fn, args.reps) * 1e3
        dec_ms = _time(dec_fn, args.reps) * 1e3
        out["codecs"][name] = {
            "encode_ms": round(enc_ms, 2),
            "decode_ms": round(dec_ms, 2),
            "ratio": round(img.nbytes / nbytes, 2),
            "lossless": lossless,
        }

    # RLE / PackBits
    u = img
    segs = [(u >> 8).astype(np.uint8).tobytes(), (u & 0xFF).astype(np.uint8).tobytes()]
    rle = _rle_encode_frame(segs)
    report("rle", lambda: _rle_encode_frame(segs), lambda: _rle_decode_frame(rle, npix, 2), len(rle))

    # JPEG Lossless SV1
    jll = jpegll.encode_jpeg_lossless(img, precision=16)
    report(
        "jpegll",
        lambda: jpegll.encode_jpeg_lossless(img, precision=16),
        lambda: jpegll.decode_jpeg_lossless(jll),
        len(jll),
    )

    # JPEG-LS lossless + near-lossless, native and oracle
    jls = jpegls.encode_jpeg_ls(img, 16)
    report("jpegls", lambda: jpegls.encode_jpeg_ls(img, 16), lambda: jpegls.decode_jpeg_ls(jls), len(jls))
    jls2 = jpegls.encode_jpeg_ls(img, 16, near=2)
    report(
        "jpegls_near2",
        lambda: jpegls.encode_jpeg_ls(img, 16, near=2),
        lambda: jpegls.decode_jpeg_ls(jls2),
        len(jls2),
        lossless=False,
    )
    report(
        "jpegls_python_oracle",
        lambda: jpegls.encode_jpeg_ls(img, 16, use_native=False),
        lambda: jpegls.decode_jpeg_ls(jls, use_native=False),
        len(jls),
    )

    # lossy sequential-DCT JPEG (.51 12-bit), native scan and oracle
    from mamri_tpu.perception import jpegdct

    i32 = img.astype(np.int32)
    jd = jpegdct.encode_jpeg_dct(i32, 12, quality=90) if img.max() < 4096 else None
    if jd is not None:
        report(
            "jpegdct_q90",
            lambda: jpegdct.encode_jpeg_dct(i32, 12, quality=90),
            lambda: jpegdct.decode_jpeg_dct(jd),
            len(jd),
            lossless=False,
        )

    # JPEG 2000 reversible, native Tier-1 and oracle
    i32 = img.astype(np.int32)
    j2k = jpeg2000.encode_jpeg2000(i32, 16)
    report("j2k", lambda: jpeg2000.encode_jpeg2000(i32, 16), lambda: jpeg2000.decode_jpeg2000(j2k), len(j2k))
    report(
        "j2k_python_oracle",
        lambda: jpeg2000.encode_jpeg2000(i32, 16, use_native=False),
        lambda: jpeg2000.decode_jpeg2000(j2k, use_native=False),
        len(j2k),
    )

    for name, c in out["codecs"].items():
        c["decode_slices_per_s"] = round(1e3 / c["decode_ms"], 1)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
