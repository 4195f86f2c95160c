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
