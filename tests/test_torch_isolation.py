"""PyTorch port: isolation from JAX, device selection, kernel build setup.

The port imports ``torch`` and never ``jax`` or anything of the JAX
package; ``chip_smoke.py`` likewise. Entry points run on the card unless
the caller asks for the CPU, and the CUDA build targets ``sm_90a``.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from llm_in_practise_tpu_torch.core.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import llm_in_practise_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
assert "llm_in_practise_tpu_torch.serve.disagg" in names, names
for name in ("serve.constrain", "serve.arrivals", "serve.multi_lora",
             "serve.adapters", "serve.kv_pool", "serve.sessions",
             "obs.logging", "obs.registry", "obs.cost", "obs.hbm",
             "obs.trace", "obs.steptrace", "obs.meter", "obs.prof",
             "obs.buildinfo", "obs.debug", "quant.gptq", "quant.ppl",
             "data.lm_dataset", "data.loader", "data.converters",
             "quantize", "sft_recipe", "models.gpt", "models.layers",
             "train.trainer", "data.chardata", "core.config",
             "minigpt_train", "gptlike_wikitext"):
    assert "llm_in_practise_tpu_torch." + name in names, names
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "flax", "llm_in_practise_tpu",
                      "ml_dtypes")
             or m.startswith(("jax.", "jaxlib.", "flax.",
                              "llm_in_practise_tpu.", "ml_dtypes.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_neither():
    forbidden = {"jax", "jaxlib", "flax", "llm_in_practise_tpu", "ml_dtypes"}
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "llm_in_practise_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        assert not (_imported_roots(path) & forbidden), path
    assert "llm_in_practise_tpu_torch" in _imported_roots(paths[0])


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, qwen3_config
    from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = qwen3_config(64, n_layer=1, hidden_size=64, intermediate_size=128,
                       head_dim=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Qwen3(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantizedModel(Qwen3(cfg, device="meta"), {})
    assert Qwen3(cfg, device="cpu").device == torch.device("cpu")


def test_training_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from llm_in_practise_tpu_torch.models.qwen3 import (
        Qwen3,
        init_params,
        qwen3_config,
    )
    from llm_in_practise_tpu_torch.peft.fused import QLoRAModel
    from llm_in_practise_tpu_torch.peft.lora import LoRAConfig
    from llm_in_practise_tpu_torch.train import __main__ as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = qwen3_config(64, n_layer=1, hidden_size=64, intermediate_size=128,
                       head_dim=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        QLoRAModel(Qwen3(cfg, device="meta"), {}, {}, LoRAConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--steps", "1"])
    state = init_params(cfg, device="cpu")
    assert state["tok_embed.weight"].device == torch.device("cpu")


def test_cli_rejects_unported_flags():
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_parser,
        check_not_ported,
    )

    base = ["--quantized_dir", "d", "--tokenizer_path", "t"]
    check_not_ported(build_parser().parse_args(base))  # the ported set
    # the KV layout defaults to paged, as the JAX CLI's does
    assert build_parser().parse_args(base).kv_layout == "paged"
    # the scheduling, admission and KV flags are ported: they parse and
    # pass
    for extra in (["--enable-chunked-prefill"], ["--decode-steps", "4"],
                  ["--no-mixed-step"], ["--max-queue", "4"],
                  ["--queue-timeout", "2.5"], ["--scan-layers"],
                  ["--model_path", "m.msgpack"],
                  ["--enable-prefix-caching"], ["--kv-layout", "paged"],
                  ["--kv-layout", "contiguous"], ["--kv-page-size", "32"],
                  ["--kv-pool-tokens", "4096"],
                  ["--kv-cache-dtype", "fp8"], ["--speculative", "4"],
                  ["--speculative"],
                  ["--speculative", "4", "--draft-model-path", "d"],
                  ["--lora-modules", "a=b"], ["--kv-offload"],
                  ["--kv-remote", "127.0.0.1:8100"],
                  ["--role", "decode", "--kv-remote", "127.0.0.1:8100"],
                  ["--session-store"],
                  ["--session-store", "--session-ttl", "30"],
                  ["--trace-file", "t.jsonl"], ["--ttft-slo", "2"],
                  ["--tpot-slo", "0.1"]):
        check_not_ported(build_parser().parse_args(base + extra))
    # the tracing and SLO flags carry their values, off by default
    args = build_parser().parse_args(base + ["--trace-file", "t.jsonl",
                                             "--ttft-slo", "2",
                                             "--tpot-slo", "0.1"])
    assert (args.trace_file, args.ttft_slo, args.tpot_slo) == (
        "t.jsonl", 2.0, 0.1)
    args = build_parser().parse_args(base)
    assert (args.trace_file, args.ttft_slo, args.tpot_slo) == (
        None, None, None)
    # --quantized_dir is optional: without it --model_path is the input
    check_not_ported(build_parser().parse_args(["--tokenizer_path", "t"]))
    # the session TTL defaults to the JAX CLI's
    assert build_parser().parse_args(base).session_ttl == 600.0
    # tensor parallelism (item 14) is still refused
    for extra, item in ((["--tensor-parallel-size", "2"], 14),
                        (["--tp-quantized-collectives"], 14)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            check_not_ported(build_parser().parse_args(base + extra))


def test_nvcc_command_targets_sm90a_into_an_ignored_dir():
    from llm_in_practise_tpu_torch.ops import _build

    cmd = _build.nvcc_command("nf4_matmul")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert cmd[-1].endswith(os.path.join("csrc", "nf4_matmul.cu"))
    assert os.path.exists(cmd[-1])
    out = cmd[cmd.index("-o") + 1]
    rel = os.path.relpath(out, REPO).split(os.sep)
    assert rel[:2] == ["build", "kernels"]
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert "build" in ignored


@pytest.mark.parametrize("name", ["nf4_matmul_bwd", "flash_attention",
                                  "int4_matmul", "int8_matmul"])
def test_training_kernels_build_for_sm90a(name, tmp_path, monkeypatch):
    from llm_in_practise_tpu_torch.ops import _build

    cmd = _build.nvcc_command(name)
    assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
    assert cmd[-1].endswith(os.path.join("csrc", f"{name}.cu"))
    assert os.path.exists(cmd[-1]) and _build.KERNELS[name]
    # the library name covers the shared headers: an edited header never
    # loads a stale build
    header = os.path.join(REPO, "llm_in_practise_tpu_torch", "csrc",
                          "mma_util.cuh")
    assert os.path.exists(header)
    before = _build.library_path(name)
    fake = tmp_path / "csrc"
    fake.mkdir()
    for f in _build.CSRC_DIR.iterdir():
        (fake / f.name).write_bytes(f.read_bytes())
    (fake / "mma_util.cuh").write_text(open(header).read() + "\n// edit\n")
    monkeypatch.setattr(_build, "CSRC_DIR", fake)
    assert _build.library_path(name) != before
