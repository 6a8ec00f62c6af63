"""Convert a downloaded pretrained LM checkpoint (a HuggingFace ProtT5
directory, or a Bepler ``lstm2x.pt``) into an LM artifact, ``params.npz``
+ ``manifest.json`` (``deepblast_tpu/cli/convert_lm.py``; the format both
packages read, ``models/convert.py``).

    python -m deepblast_torch.cli.convert_lm ~/prot_t5_xl_uniref50/ \\
        --output lm_artifact/
    python -m deepblast_torch.cli.convert_lm lstm2x.pt --kind bilstm \\
        --output bilm_artifact/
    python -m deepblast_torch.cli.train --pretrain-path lm_artifact/ ...

It runs on the CPU and needs no network; it prints the manifest.
"""

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="deepblast-convert-lm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint",
                   help="HF checkpoint directory (pytorch_model.bin) or a "
                        "torch .pt/.bin file")
    p.add_argument("--output", required=True,
                   help="output artifact directory")
    p.add_argument("--kind", choices=["auto", "prot_t5", "bilstm"],
                   default="auto",
                   help="checkpoint family (default: detect from keys)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype of the artifact (bfloat16 halves "
                        "it)")
    p.add_argument("--no-strict", action="store_true",
                   help="warn instead of fail on layout mismatches")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from deepblast_torch.models.convert import convert_checkpoint
    manifest = convert_checkpoint(
        args.checkpoint, args.output, kind=args.kind,
        dtype=None if args.dtype == "float32" else args.dtype,
        strict=not args.no_strict)
    print(json.dumps(manifest, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
