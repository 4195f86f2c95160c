"""Shared helpers of the PyTorch-port tests (``tests/test_torch_*.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "qwen3_tiny")


def load_fixture_both():
    """The committed HF fixture through the JAX loader (f32, f32 compute),
    and the same weights carried into a CPU port model."""
    from llm_in_practise_tpu.models.hf_loader import load_qwen3
    from llm_in_practise_tpu_torch.models.convert import params_from_jax
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config

    jmodel, jparams = load_qwen3(
        FIXTURE, dtype=jnp.float32,
        config_overrides={"compute_dtype": "float32"})
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    pmodel = Qwen3(cfg, device="cpu")
    pmodel.load_state(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, pmodel


def numpy_params(jax_model, seed: int):
    """A flax param tree for ``jax_model`` filled from a numpy seed: norm
    scales near 1, the embedding N(0, 1) (a residual stream of unit RMS,
    so RMSNorm does not magnify rounding differences), everything else
    N(0, 0.05)."""
    from llm_in_practise_tpu.utils.tree import path_str

    shapes = jax.eval_shape(
        lambda: jax_model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path_str(path)
        if name.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "tok_embed/embedding":
            v = rng.standard_normal(leaf.shape)
        else:
            v = 0.05 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_port_model(vocab_size: int, seed: int = 0, **cfg_kw):
    """A small random Qwen3 in the port, on the CPU, weights from numpy."""
    import torch

    from llm_in_practise_tpu_torch.models.convert import expected_names
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, qwen3_config

    cfg = qwen3_config(vocab_size, compute_dtype="float32", **cfg_kw)
    model = Qwen3(cfg, device="cpu")
    shapes = dict(model.named_parameters())
    rng = np.random.default_rng(seed)
    state = {}
    for name in sorted(expected_names(cfg)):
        shape = tuple(shapes[name].shape)
        v = (1.0 + 0.1 * rng.standard_normal(shape) if name.endswith("scale")
             else 0.05 * rng.standard_normal(shape))
        state[name] = torch.from_numpy(v.astype(np.float32))
    model.load_state(state)
    return model


def run_port_engine(model, eos_id, prompts, params):
    """Serve ``prompts`` at once through the port's engine (2 slots,
    contiguous f32 KV): ``[(tokens, finish_reason)]``."""
    import torch

    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(model, max_slots=2, cache_len=64, eos_id=eos_id,
                          cache_dtype=torch.float32)
    reqs = [eng.submit(p, params) for p in prompts]
    while eng.step():
        pass
    return [(r.result(), r.finish_reason) for r in reqs]


def run_jax_engine(model, params, eos_id, prompts, new_tokens):
    """The same through the JAX engine, greedy, ``new_tokens`` each."""
    from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
    from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams

    eng = JaxEngine(model, params, max_slots=2, cache_len=64, eos_id=eos_id,
                    cache_dtype=jnp.float32, kv_layout="contiguous")
    reqs = [eng.submit(p, JaxParams(greedy=True, max_tokens=new_tokens))
            for p in prompts]
    while eng.step():
        pass
    out = [(r.result(), r.finish_reason) for r in reqs]
    eng.stop()
    return out
