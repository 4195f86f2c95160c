"""PyTorch port: greedy serving of PTQ exports, against the JAX engine.

The 2-layer model and exports of ``tests/test_torch_ptq_serve.py``. The
port's engine over the int4 and AWQ exports (the plain versions of the
int4 kernels on the CPU) gives the JAX engine's tokens (Pallas kernels in
interpret mode) exactly: the two differ by bf16 rounding noise only, far
below the gap between the top two logits of these greedy streams. Two
prompts of different lengths decode side by side (slot reuse is covered
by ``tests/test_torch_engine.py``).
"""

import jax.numpy as jnp
import pytest
import torch

from test_torch_ptq_serve import PTQ_CFG, VOCAB, ptq_tree
from test_torch_ptq_step import carried
from torch_port_util import numpy_params, run_jax_engine, run_port_engine

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.serve.quantized import QuantizedModel as JaxQuantized
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3
from llm_in_practise_tpu_torch.serve.engine import SamplingParams
from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

PROMPTS = [[3, 17, 42, 9, 88, 5, 61], [120, 7, 7, 33]]
NEW_TOKENS = 6


@pytest.mark.parametrize("fmt", ["int4", "awq"])
def test_greedy_tokens_identical_to_jax_engine(fmt):
    jmodel = JaxQwen3(jax_qwen3_config(VOCAB, **PTQ_CFG))
    qtree = ptq_tree(numpy_params(jmodel, seed=7), fmt)
    cfg, state = carried(jmodel, qtree)
    pq = QuantizedModel(Qwen3(cfg, device="meta"), state,
                        compute_dtype=torch.float32, device="cpu")
    port = run_port_engine(pq, None, PROMPTS,
                           SamplingParams(greedy=True, max_tokens=NEW_TOKENS))
    jax_out = run_jax_engine(JaxQuantized(jmodel, compute_dtype=jnp.float32),
                             qtree, None, PROMPTS, NEW_TOKENS)
    assert port == jax_out
    assert all(f == "length" and len(t) == NEW_TOKENS for t, f in port)
