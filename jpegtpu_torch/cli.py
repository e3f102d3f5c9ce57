"""Command-line interface (counterpart of `jpegtpu/cli.py`): the same
subcommands, flags and defaults, and `--device` (default cuda; `cpu`
runs the kernels' plain PyTorch versions), which every entry point is
given. Without a card the default raises; nothing falls back to the CPU.

    python -m jpegtpu_torch.cli encode in.bmp out.jpg [--quality 50]
        [--subsampling gray|420|422|444] [--restart-interval N]
        [--entropy device|host] [--optimize-huffman] [--sharded]
        [--stats] [--device cuda|cpu]
    python -m jpegtpu_torch.cli encode-dir in_dir out_dir [--pipeline D]
    python -m jpegtpu_torch.cli profile in.bmp [--subsampling 420]
    python -m jpegtpu_torch.cli analyze orig.bmp compressed.jpg [-o diff.png]
    python -m jpegtpu_torch.cli analyze-dir in_dir out_dir [-d diff_dir]

`analyze` and `analyze-dir` need PIL, and a difference figure matplotlib.
"""
from __future__ import annotations

import argparse
import sys
import time


def _cmd_encode(args) -> int:
    from . import pipeline
    from .config import EncodeConfig

    config = EncodeConfig(
        quality=args.quality,
        subsampling=args.subsampling,
        restart_interval=args.restart_interval,
        entropy=args.entropy,
        optimize_huffman=args.optimize_huffman,
    )
    t0 = time.perf_counter()
    if args.sharded:
        from .io import bmp as bmp_io

        img = bmp_io.read(args.input)
        # no device: the mesh is sharding.make_mesh(), every CUDA device of
        # the process (the global mesh across processes)
        device = None if args.device == "cuda" else args.device
        if config.subsampling == "gray":
            from .parallel import sharding

            data = sharding.encode_grayscale_sharded(img, config,
                                                     device=device)
        else:
            from . import color_pipeline

            data = color_pipeline.encode_color_sharded(img, config,
                                                       device=device)
        with open(args.output, "wb") as f:
            f.write(data)
        nbytes = len(data)
    else:
        nbytes = pipeline.encode_file(args.input, args.output, config,
                                      device=args.device)
    dt = time.perf_counter() - t0
    if args.stats:
        from .io import bmp

        img = bmp.read(args.input)
        h, w = img.shape[:2]
        print(
            f"{args.input} {w}x{h} -> {args.output} {nbytes} bytes "
            f"({w * h / dt / 1e6:.1f} MPix/s incl. warmup/compile)",
            file=sys.stderr,
        )
    return 0


def _cmd_encode_dir(args) -> int:
    """Batch encode: every BMP in <input_dir> -> <output_dir>/<stem>.jpeg,
    by the batch encoders (batch.encode_*_batch), or with --pipeline by
    serving.encode_stream with DEPTH encodes in flight."""
    import glob
    import os

    from . import batch
    from .config import EncodeConfig
    from .io import bmp as bmp_io

    config = EncodeConfig(
        quality=args.quality,
        subsampling=args.subsampling,
        entropy="device",
    )
    paths = sorted(glob.glob(os.path.join(args.input_dir, "*.bmp")))
    if not paths:
        print("no .bmp files found", file=sys.stderr)
        return 1
    images = [bmp_io.read(p) for p in paths]
    t0 = time.perf_counter()
    if args.pipeline:
        from . import serving

        outs = serving.encode_stream_list(
            images, config, color=config.subsampling != "gray",
            depth=args.pipeline, device=args.device)
    elif config.subsampling == "gray":
        outs = batch.encode_grayscale_batch(images, config,
                                            device=args.device)
    else:
        outs = batch.encode_color_batch(images, config, device=args.device)
    dt = time.perf_counter() - t0
    os.makedirs(args.output_dir, exist_ok=True)
    total_px = 0
    for p, img, data in zip(paths, images, outs):
        stem = os.path.splitext(os.path.basename(p))[0]
        with open(os.path.join(args.output_dir, stem + ".jpeg"), "wb") as f:
            f.write(data)
        total_px += img.shape[0] * img.shape[1]
    if args.stats:
        print(
            f"{len(paths)} images, {total_px / 1e6:.1f} MPix in {dt:.2f}s "
            f"({total_px / dt / 1e6:.1f} MPix/s incl. warmup/compile)",
            file=sys.stderr,
        )
    return 0


def _cmd_profile(args) -> int:
    """Per-stage timing table of the encode (profiling)."""
    from . import profiling
    from .config import EncodeConfig
    from .io import bmp as bmp_io

    img = bmp_io.read(args.input)
    h, w = img.shape[:2]
    if args.subsampling == "gray":
        stages = profiling.profile_encode(
            img, EncodeConfig(quality=args.quality), reps=args.reps,
            device=args.device)
    else:
        stages = profiling.profile_encode_color(
            img,
            EncodeConfig(quality=args.quality, subsampling=args.subsampling),
            reps=args.reps, device=args.device,
        )
    print(profiling.format_report(stages, h, w))
    return 0


def _cmd_analyze(args) -> int:
    from .analysis import analyze_pair, format_report

    result = analyze_pair(args.original, args.compressed, diff_path=args.output)
    print(format_report(result))
    return 0


def _cmd_analyze_dir(args) -> int:
    """Batch analysis: for each <input_dir>/*.bmp with a matching compressed
    file in <output_dir>, analyze and (optionally) render a difference map
    — the reference's run_analysis.sh:13-34 loop."""
    import glob
    import os

    from .analysis import analyze_pair, format_report

    n = 0
    for bmp_path in sorted(glob.glob(os.path.join(args.input_dir, "*.bmp"))):
        stem = os.path.splitext(os.path.basename(bmp_path))[0]
        comp = None
        for ext in (".jpeg", ".jpg"):
            cand = os.path.join(args.output_dir, stem + ext)
            if os.path.exists(cand):
                comp = cand
                break
        if comp is None:
            continue
        diff = None
        if args.difference_dir:
            os.makedirs(args.difference_dir, exist_ok=True)
            diff = os.path.join(args.difference_dir, stem + ".png")
        print(format_report(analyze_pair(bmp_path, comp, diff_path=diff)))
        print()
        n += 1
    if n == 0:
        print("no matching (input.bmp, output.jpeg) pairs found", file=sys.stderr)
        return 1
    return 0


def _device_flag(parser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the encode runs on (default cuda; cpu runs the "
        "kernels' plain PyTorch versions)",
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jpegtpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    enc = sub.add_parser("encode", help="BMP in, baseline JPEG out")
    enc.add_argument("input")
    enc.add_argument("output")
    enc.add_argument("--quality", type=int, default=50)
    enc.add_argument(
        "--subsampling", choices=["gray", "420", "422", "444"], default="gray"
    )
    enc.add_argument("--restart-interval", type=int, default=0)
    enc.add_argument("--entropy", choices=["device", "host"], default="device")
    enc.add_argument(
        "--optimize-huffman", action="store_true",
        help="2-pass optimal Huffman tables (smaller files)",
    )
    enc.add_argument(
        "--sharded", action="store_true",
        help="shard MCU rows across every CUDA device of the process, or "
        "the one --device names (restart-marker stitching)",
    )
    enc.add_argument("--stats", action="store_true")
    _device_flag(enc)
    enc.set_defaults(fn=_cmd_encode)

    encd = sub.add_parser(
        "encode-dir", help="batch-encode every BMP in a directory"
    )
    encd.add_argument("input_dir")
    encd.add_argument("output_dir")
    encd.add_argument("--quality", type=int, default=50)
    encd.add_argument(
        "--subsampling", choices=["gray", "420", "422", "444"], default="gray"
    )
    encd.add_argument(
        "--pipeline", type=int, default=0, metavar="DEPTH",
        help="overlapped per-image encodes with DEPTH in flight "
        "(serving.encode_stream) instead of shape-grouped batches — for "
        "directories of heterogeneous shapes",
    )
    encd.add_argument("--stats", action="store_true")
    _device_flag(encd)
    encd.set_defaults(fn=_cmd_encode_dir)

    prof = sub.add_parser(
        "profile", help="per-stage timing table of the encode"
    )
    prof.add_argument("input")
    prof.add_argument("--quality", type=int, default=50)
    prof.add_argument(
        "--subsampling", choices=["gray", "420", "422", "444"], default="gray"
    )
    prof.add_argument("--reps", type=int, default=5)
    _device_flag(prof)
    prof.set_defaults(fn=_cmd_profile)

    ana = sub.add_parser(
        "analyze", help="quality metrics vs original (MSE/PSNR/SSIM/CR/BPP)"
    )
    ana.add_argument("original")
    ana.add_argument("compressed")
    ana.add_argument("-o", "--output", default=None, help="difference-map PNG")
    ana.set_defaults(fn=_cmd_analyze)

    bat = sub.add_parser(
        "analyze-dir",
        help="batch analysis over a corpus (the reference's run_analysis.sh)",
    )
    bat.add_argument("input_dir")
    bat.add_argument("output_dir")
    bat.add_argument("-d", "--difference-dir", default=None)
    bat.set_defaults(fn=_cmd_analyze_dir)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
