"""PyTorch port: the continuous-batching engine against the JAX engine.

Both engines serve the committed HF fixture in f32 (compute and KV cache;
the JAX engine's default KV dtype is bf16, so it is set explicitly) in the
contiguous layout with two slots, and take three greedy prompts of
different lengths at once, so one slot is reused. The greedy token ids
must be identical and the finish reasons must agree.

The same holds for the tiny NF4 model of ``tests/test_torch_qwen3.py``
served through both packages' ``QuantizedModel`` (JAX: Pallas kernel in
interpret mode; port: the kernel's plain version on the CPU). The two
differ by bf16 rounding noise only (see that file), far below the gap
between the top two logits of these greedy streams.

Seeded sampling cannot be compared token for token: the port draws from a
``torch.Generator`` and the JAX engine from ``jax.random``, which give
different numbers from the same seed. It is checked by distribution: with
``top_k=5`` every sampled token lies in the top 5 of the port's own
logits at its position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    load_fixture_both,
    numpy_params,
    run_jax_engine,
    run_port_engine,
    tiny_port_model,
)

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu.serve.quantized import QuantizedModel as JaxQuantized
from llm_in_practise_tpu_torch.models.convert import params_from_jax
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

PROMPTS = [[3, 17, 42, 9, 88, 5, 61], [120, 7, 7, 33], [11, 90, 54, 2, 150,
                                                        19, 64, 8, 31, 77]]
NEW_TOKENS = 12


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def test_greedy_tokens_identical_to_jax_engine(fixture_models):
    jmodel, jparams, pmodel = fixture_models
    greedy = SamplingParams(greedy=True, max_tokens=NEW_TOKENS)
    # pick an EOS that one stream reaches mid-way, so both finish reasons
    # ("stop" on EOS, "length" on the budget) occur
    free = run_port_engine(pmodel, None, PROMPTS, greedy)
    eos = free[1][0][4]
    port = run_port_engine(pmodel, eos, PROMPTS, greedy)

    jax_out = run_jax_engine(jmodel, jparams, eos, PROMPTS, NEW_TOKENS)

    assert [t for t, _ in port] == [t for t, _ in jax_out]
    assert [f for _, f in port] == [f for _, f in jax_out]
    reasons = {f for _, f in port}
    assert reasons == {"stop", "length"}, reasons
    assert all(len(t) == NEW_TOKENS for t, f in port if f == "length")


def test_nf4_greedy_tokens_identical_to_jax_engine():
    jmodel = JaxQwen3(jax_qwen3_config(
        512, hidden_size=256, intermediate_size=512, n_head=4, n_kv_head=2,
        head_dim=128, n_layer=2, compute_dtype="float32", max_seq_len=64))
    qtree = jax_nf4.quantize_tree(
        numpy_params(jmodel, seed=7),
        lambda p, leaf: p.startswith("block_") and p.endswith("kernel"))
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    pq = QuantizedModel(
        Qwen3(cfg, device="meta"),
        params_from_jax(jax.tree.map(np.asarray, qtree), cfg),
        compute_dtype=torch.float32, device="cpu")
    port = run_port_engine(pq, None, PROMPTS,
                           SamplingParams(greedy=True, max_tokens=NEW_TOKENS))
    jax_out = run_jax_engine(JaxQuantized(jmodel, compute_dtype=jnp.float32),
                             qtree, None, PROMPTS, NEW_TOKENS)
    assert port == jax_out
    assert all(f == "length" and len(t) == NEW_TOKENS for t, f in port)


def test_seeded_sampling_stays_in_top_k():
    model = tiny_port_model(256, seed=3)
    params = SamplingParams(temperature=1.0, top_k=5, max_tokens=10)
    outs = run_port_engine(model, None, PROMPTS[:2], params)
    for prompt, (toks, _) in zip(PROMPTS, outs):
        assert len(toks) == 10
        seq = torch.tensor([prompt + toks])
        with torch.inference_mode():
            logits = model(seq)[0]
        for j, tok in enumerate(toks):
            top5 = torch.topk(logits[len(prompt) - 1 + j], 5).indices.tolist()
            assert tok in top5
    # the same seed replays the same draws
    assert run_port_engine(model, None, PROMPTS[:2], params) == outs


def test_slot_reuse_and_budget_bookkeeping():
    model = tiny_port_model(256, seed=4)
    eng = InferenceEngine(model, max_slots=1, cache_len=16,
                          cache_dtype=torch.float32)
    reqs = [eng.submit([1, 2, 3], SamplingParams(greedy=True, max_tokens=3)),
            eng.submit(list(range(40)), SamplingParams(greedy=True,
                                                      max_tokens=50))]
    while eng.step():
        pass
    assert len(reqs[0].result()) == 3 and reqs[0].finish_reason == "length"
    # the long prompt is cropped to cache_len - 2 and stops on cache room
    assert len(reqs[1].prompt_ids) == 14
    assert reqs[1].finish_reason == "cache"
    assert eng.slot_req == [None]


@pytest.mark.parametrize("knob", [
    dict(mesh=object()),
    dict(adapter_registry=dict(mesh=object())), dict(role="prefill"),
    dict(role="router"), dict(session_store=object())])
def test_unported_engine_knobs_raise(knob):
    from llm_in_practise_tpu_torch.serve.multi_lora import AdapterRegistry

    model = tiny_port_model(64, seed=5)
    if "role" in knob:
        # the KV tiers and the handoff are ported: a prefill role needs a
        # handoff store, and a role must be one of the three (JAX :776)
        with pytest.raises(ValueError, match="role"):
            InferenceEngine(model, **knob)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if "adapter_registry" in knob:
            # LoRA serving is ported; its registry's tensor-parallel bank
            # placement is not (queue A item 14)
            knob = dict(adapter_registry=AdapterRegistry(
                model, **knob["adapter_registry"]))
        InferenceEngine(model, **knob)


@pytest.mark.parametrize("knob", [dict(prefix_cache=True),
                                  dict(kv_layout="paged"),
                                  dict(speculative_k=4)])
def test_prefix_cache_and_paged_knobs_construct_and_serve(knob):
    """The knobs that raised until the paged KV and speculative decoding
    slices: they construct and serve the same greedy tokens as the plain
    contiguous engine."""
    model = tiny_port_model(64, seed=5)
    prompt = [(i * 3 + 1) % 64 for i in range(20)]
    sp = SamplingParams(greedy=True, max_tokens=8)
    eng = InferenceEngine(model, max_slots=2, cache_len=48,
                          cache_dtype=torch.float32, **knob)
    plain = InferenceEngine(model, max_slots=2, cache_len=48,
                            cache_dtype=torch.float32)
    assert eng.generate(prompt, sp) == plain.generate(prompt, sp)
    assert eng.generate(prompt, sp) == plain.generate(prompt, sp)
    if "prefix_cache" in knob:
        assert eng.prefix_cache.hits == 1
    elif "speculative_k" in knob:
        assert eng.spec_rounds > 0
    else:
        eng.paged.pool.check_leaks(0)


def test_unported_submit_arguments_raise():
    eng = InferenceEngine(tiny_port_model(64, seed=5), max_slots=1,
                          cache_len=16, cache_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="item 5"):
        eng.submit([1, 2, 3], session_id="s")
    # kv_entry is ported (the disaggregated handoff): an entry that does
    # not fit the prompt is counted in kv_rejected and the request
    # prefills locally
    from llm_in_practise_tpu_torch.serve.kv_pool import HostEntry

    bogus = HostEntry(length=2, bucket=2, rows=[], last_logits=None)
    req = eng.submit([1, 2, 3], SamplingParams(greedy=True, max_tokens=2),
                     kv_entry=bogus)
    while eng.step():
        pass
    assert eng.kv_rejected == 1 and eng.kv_admitted == 0
    assert len(req.result()) == 2


def test_background_thread_serves_and_stops():
    model = tiny_port_model(64, seed=6)
    eng = InferenceEngine(model, max_slots=2, cache_len=32,
                          cache_dtype=torch.float32)
    eng.start()
    try:
        want = [eng.submit([5, 6, 7], SamplingParams(greedy=True,
                                                     max_tokens=4))
                for _ in range(3)]
        got = [r.result() for r in want]
        assert all(g == got[0] and len(g) == 4 for g in got)
        assert all(r.ttft_s is not None and r.tpot_s is not None
                   for r in want)
    finally:
        eng.stop()
    assert not eng.is_alive()
    np.testing.assert_array_equal(eng.slot_ready, [False, False])
