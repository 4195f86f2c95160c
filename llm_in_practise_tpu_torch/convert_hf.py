"""Convert an HF Qwen3 safetensors checkpoint to a packed quantized export.

Port of ``examples/convert_hf.py``:

    python -m llm_in_practise_tpu_torch.convert_hf --model_dir HF_DIR \\
        --out_dir OUT [--quantization int8|nf4] [--device cpu]
    python -m llm_in_practise_tpu_torch.serve --quantized_dir OUT ...

Loads the checkpoint tensor by tensor in bf16 onto the device (the card
unless ``--device cpu``), quantizes every block kernel to int8 (W8A16
per-channel, no calibration) or NF4, one leaf at a time, each bf16 leaf
freed as its packed leaf lands, and writes ``OUT/packed.npz`` +
``OUT/manifest.json`` in the JAX package's format, with its metadata keys
(``config``, ``family``, ``method``, ``source``).
"""

from __future__ import annotations

import argparse
import os
import sys

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models.convert import params_to_jax
from llm_in_practise_tpu_torch.models.hf_loader import load_qwen3
from llm_in_practise_tpu_torch.peft.qlora import quantize_base
from llm_in_practise_tpu_torch.quant import io as quant_io
from llm_in_practise_tpu_torch.serve.quantized import QUANT_LEAVES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.convert_hf",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True,
                   help="HF checkpoint dir (config.json + *.safetensors)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--quantization", default="int8", choices=["int8", "nf4"])
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, state = load_qwen3(args.model_dir, device=device)
    n = sum(t.numel() for t in state.values())
    print(f"loaded {n / 1e9:.2f}B params from {args.model_dir}")
    qstate = {}
    for name in list(state):
        qstate.update(quantize_base({name: state.pop(name)},
                                    fmt=args.quantization))
    path = quant_io.save_packed(
        args.out_dir, params_to_jax(qstate, cfg),
        metadata={"config": cfg.to_dict(), "family": "qwen3",
                  "method": args.quantization,
                  "source": os.path.abspath(args.model_dir)})
    packed = sum(leaf.nbytes for leaf in qstate.values()
                 if isinstance(leaf, QUANT_LEAVES))
    print(f"packed {args.quantization} export -> {path} "
          f"({packed / 2**30:.2f} GiB quantized)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
