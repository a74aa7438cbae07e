"""Command-line interface of the port.

The counterpart of ``python -m ebcc_tpu.api.cli``: ``spec`` prints the
same HDF5 filter spec strings, and ``compress`` / ``decompress`` code
``.npy`` files through the port's ``encode_chunked_compat``,
``decode_chunked`` and ``decode_chunked_region`` on the CUDA card, or on the
CPU with ``--device cpu``.

Parity: the reference's ``python ebcc/filter_wrapper.py`` CLI
(filter_wrapper.py:70-115) which prints an HDF5 filter spec string
``"<id>,<h>,<w>,<base_cr bits>,<mode>[,<err bits>]"`` consumable by
``cdo --filter`` / netCDF tooling (README.md:63-78), plus direct file
compression/decompression subcommands.

Usage (``--device cpu`` runs ``compress`` / ``decompress`` on the CPU):
  python -m ebcc_tpu_torch.api.cli spec -b 200 -H 721 -W 1440 -r 0.01
  python -m ebcc_tpu_torch.api.cli compress in.npy out.etpk --max-error 0.5
  python -m ebcc_tpu_torch.api.cli decompress in.etpk out.npy [--region R]
"""

from __future__ import annotations

import argparse
import sys

from .filter_wrapper import EBCC_Filter


def _add_spec_args(p):
    p.add_argument("-b", "--base_cr", type=str, default=200,
                   help="base compression ratio")
    p.add_argument("-H", "--height", type=int, default=721,
                   help="height of the data slice or size of latitude dim")
    p.add_argument("-W", "--width", type=int, default=1440,
                   help="width of the data slice or size of longitude dim")
    p.add_argument("-m", "--max_error_target", default=None, type=float,
                   help="max error target")
    p.add_argument("-r", "--relative_error_target", default=None, type=float,
                   help="relative error target")
    p.add_argument("-p", "--pointwise_relative_error_target", default=None,
                   type=float,
                   help="pointwise relative error target (TPU-build "
                        "extension; strictly positive data)")
    p.add_argument("--lossless", action="store_true",
                   help="bit-exact spec (TPU-build extension)")
    p.add_argument("--help-cdo", action="store_true", help="print CDO help")


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="device that codes the data: cuda (default) or cpu")


def _spec_main(args) -> int:
    if args.max_error_target:
        residual_opt = ("max_error_target", float(args.max_error_target))
    elif args.relative_error_target:
        residual_opt = ("relative_error_target",
                        float(args.relative_error_target))
    elif args.pointwise_relative_error_target is not None:
        residual_opt = ("pointwise_relative_error_target",
                        float(args.pointwise_relative_error_target))
    elif args.lossless:
        residual_opt = ("lossless", 0)
    else:
        print("Using default settings: relative error target of 0.01",
              file=sys.stderr)
        residual_opt = ("relative_error_target", 0.01)

    filt = EBCC_Filter(base_cr=float(args.base_cr), height=args.height,
                       width=args.width, residual_opt=residual_opt)

    print("======Configuration======", file=sys.stderr)
    print(f"Base compression ratio: {args.base_cr}", file=sys.stderr)
    print(f"HeightxWidth: {args.height}x{args.width}", file=sys.stderr)
    print(f"Residual option: {residual_opt[0]}, {residual_opt[1]}",
          file=sys.stderr)

    opts = ",".join(str(o) for o in filt.hdf_filter_opts)
    opts = f"{EBCC_Filter.FILTER_ID},{opts}"
    if args.help_cdo:
        print(f"Compression using cdo: cdo -b F32 -f nc4 --filter {opts} "
              "copy original.nc compressed.nc")
        print(f"Make sure to check chunksize of original.nc divides the tile "
              f"size {args.height}x{args.width}")
    print(opts)
    return 0


def _compress_main(args) -> int:
    import numpy as np

    from .. import CodecConfig, encode_chunked_compat
    from ..config import (RESIDUAL_MAX_ERROR, RESIDUAL_NONE,
                          RESIDUAL_POINTWISE_RELATIVE_ERROR,
                          RESIDUAL_RELATIVE_ERROR)

    data = np.load(args.input).astype(np.float32)
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        data = data.reshape(-1, *data.shape[-2:])
    if args.max_error is not None:
        mode, err = RESIDUAL_MAX_ERROR, args.max_error
    elif args.relative_error is not None:
        mode, err = RESIDUAL_RELATIVE_ERROR, args.relative_error
    elif args.pointwise_relative_error is not None:
        mode, err = (RESIDUAL_POINTWISE_RELATIVE_ERROR,
                     args.pointwise_relative_error)
    elif args.lossless:
        from ..config import RESIDUAL_LOSSLESS
        mode, err = RESIDUAL_LOSSLESS, 0.0
    else:
        mode, err = RESIDUAL_NONE, 0.0
    if args.temporal and mode not in (RESIDUAL_MAX_ERROR,
                                      RESIDUAL_RELATIVE_ERROR,
                                      RESIDUAL_POINTWISE_RELATIVE_ERROR):
        print("--temporal requires an error-bounded mode", file=sys.stderr)
        return 2
    config = CodecConfig(dims=data.shape, base_cr=args.base_cr,
                         residual_mode=mode, error=err,
                         chunk_dims=tuple(args.chunk_dims or (0, 0, 0)),
                         entropy_backend=args.entropy,
                         temporal=bool(args.temporal),
                         allow_nan=bool(args.allow_nan))
    blob = encode_chunked_compat(data, config, device=args.device)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"{args.input}: {data.nbytes} -> {len(blob)} bytes "
          f"(CR {data.nbytes / len(blob):.2f})", file=sys.stderr)
    return 0


def _decompress_main(args) -> int:
    import numpy as np

    from .. import decode_chunked, decode_chunked_region

    with open(args.input, "rb") as f:
        blob = f.read()
    if args.region:
        from ..core import stream as _stream
        try:
            region = tuple(
                (int(a), int(b))
                for a, b in (part.split(":") for part in
                             args.region.split(",")))
            if len(region) != 3:
                raise ValueError
            out = decode_chunked_region(blob, region, device=args.device)
        except _stream.StreamError:
            raise  # corrupt container — not a --region usage problem
        except ValueError as e:
            print(f"--region must be t0:t1,y0:y1,x0:x1 within the "
                  f"container dims ({e})", file=sys.stderr)
            return 2
    else:
        out = decode_chunked(blob, device=args.device)
    np.save(args.output, out)
    print(f"{args.input}: -> {out.shape} float32", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Bare invocation parity: reference CLI has no subcommands, only spec.
    if not argv or argv[0].startswith("-"):
        argv = ["spec"] + argv

    parser = argparse.ArgumentParser(prog="ebcc_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("spec", help="print an HDF5/CDO filter spec")
    _add_spec_args(sp)

    cp = sub.add_parser("compress", help="compress a .npy array file")
    cp.add_argument("input")
    cp.add_argument("output")
    cp.add_argument("--base-cr", type=float, default=30.0)
    cp.add_argument("--max-error", type=float, default=None)
    cp.add_argument("--relative-error", type=float, default=None)
    cp.add_argument("--pointwise-relative-error", type=float, default=None,
                    help="bound |out-in| <= f*|in| on EVERY sample "
                         "(strictly positive data only)")
    cp.add_argument("--lossless", action="store_true",
                    help="bit-exact float32 round trip (NaN/Inf included)")
    cp.add_argument("--chunk-dims", type=int, nargs=3, default=None)
    cp.add_argument("--temporal", action="store_true",
                    help="closed-loop predictive coding along the chunk's "
                         "leading axis (error-bounded modes only)")
    cp.add_argument("--allow-nan", action="store_true",
                    help="mask NaN samples (restored on decode; bound "
                         "applies to valid samples) instead of failing")
    _add_device_arg(cp)
    cp.add_argument("--entropy", choices=("zstd", "cab", "auto"),
                    default="zstd",
                    help="entropy backend: cab/auto trade encode time for "
                         "a better ratio")

    dp = sub.add_parser("decompress", help="decompress to a .npy array file")
    dp.add_argument("input")
    dp.add_argument("output")
    dp.add_argument("--region", default=None,
                    help="random-access sub-region 't0:t1,y0:y1,x0:x1' "
                         "(decodes only the chunks it touches)")
    _add_device_arg(dp)

    args = parser.parse_args(argv)
    if args.cmd == "spec":
        return _spec_main(args)
    if args.cmd == "compress":
        return _compress_main(args)
    return _decompress_main(args)


if __name__ == "__main__":
    sys.exit(main())
