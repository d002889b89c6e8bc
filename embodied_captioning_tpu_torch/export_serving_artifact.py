"""Export the serving artifact from a `selfcheck_detector --save` pickle:
the detector weights serving runs (GroupNorm weights, the EMA where the
self-check served it, or the calibrated affine weights folded into their
convolutions), quantized to int8 per output channel, with the serving
configuration and the measured quality metrics.

The counterpart of the JAX package's `scripts/export_serving_artifact.py`,
with its arguments and its JSON line. It reads the `--save` pickle of
either package's self-check and writes a numpy-tree pickle that
`params.load_detector_artifact` and the JAX package's readers both load
(int8 leaves under the JAX package's `QuantizedArray` name). The weights
are loaded, folded and quantized on the GPU (or on the CPU with --device
cpu). `--norm affine` refuses the query family, which has no affine fold.

Usage:
  python -m embodied_captioning_tpu_torch.export_serving_artifact ART \\
      --out OUT.pkl [--norm gn|affine] [--metrics '{"map50": 0.83}'] \\
      [--device cpu]

Prints {"out", "mb", "norm"}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("artifact")
    ap.add_argument("--out", required=True)
    ap.add_argument("--norm", default="gn", choices=["gn", "affine"],
                    help="serve the GroupNorm weights (the EMA where the "
                         "self-check chose it), or the calibrated "
                         "frozen-affine weights folded into their convs")
    ap.add_argument("--metrics", default=None,
                    help="JSON of measured quality metrics to embed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("export_serving_artifact: no CUDA device (pass --device cpu "
              "to run on the CPU)", file=sys.stderr)
        return 2

    from .config import load_config, merge, to_dict
    from .models import detector as DET
    from .models.quantize import quantize_params
    from .params import dump_tree, from_jax, load_pickle, to_numpy

    art = load_pickle(args.artifact)
    cfg = merge(load_config("tiny"), {"detector": art["serving_cfg"]})
    if args.norm == "affine":
        if art.get("affine") is None:
            raise ValueError("--norm affine needs a --calibrate artifact")
        dcfg = dataclasses.replace(cfg.detector, norm="affine")
        params = DET.fold_affine(from_jax(art["affine"], args.device),
                                 dcfg)
    else:
        dcfg = dataclasses.replace(cfg.detector, norm="gn")
        best = art.get("ema") if art.get("best") == "ema" else None
        params = from_jax(best if best is not None else art["params"],
                          args.device)
    served = to_numpy(quantize_params(params, min_size=64))
    out = {
        "served": served,
        "serving_cfg": to_dict(dcfg),
        "metrics": json.loads(args.metrics) if args.metrics else {},
        "source": os.path.basename(args.artifact),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    dump_tree(out, args.out)
    size = os.path.getsize(args.out) / 2**20
    print(json.dumps({"out": args.out, "mb": round(size, 1),
                      "norm": args.norm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
