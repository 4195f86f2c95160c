"""PyTorch port: the training modules against the JAX package.

Losses, optimizers and schedules take the same numpy-seeded inputs in
both frameworks. Tolerances: the fused cross-entropy multiplies bf16
operands with f32 sums in both (on the CPU the port widens bf16 to f32,
which is exact), so the loss agrees to f32 summation order (1e-5
relative) and the gradient to bf16 rounding of the backward's operands
(1e-2 of its largest entry); optimizer and schedule updates are the
same formulas, rounded in another order (1e-5 of an update, 1e-6 of a
rate). The SFT arrays must be identical.
The whole QLoRA step lives in ``tests/test_torch_qlora_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_in_practise_tpu.data import sft as jax_sft
from llm_in_practise_tpu.peft import lora as jax_lora
from llm_in_practise_tpu.peft import qlora as jax_qlora
from llm_in_practise_tpu.train import losses as jax_losses
from llm_in_practise_tpu.train import optim as jax_optim
from llm_in_practise_tpu.train import schedules as jax_sched
from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu_torch.data import sft
from llm_in_practise_tpu_torch.models.convert import (
    flax_path,
    lora_from_jax,
    params_from_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3Config
from llm_in_practise_tpu_torch.peft import lora, qlora
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor
from llm_in_practise_tpu_torch.train import losses, optim, schedules
from llm_in_practise_tpu_torch.train import __main__ as train_cli
from llm_in_practise_tpu_torch.train.step import make_train_step
from torch_port_util import numpy_params

# ------------------------------------------------------------------ losses


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    labels[0, :2] = losses.IGNORE_INDEX
    want, want_n = jax_losses.cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels))
    got, got_n = losses.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    assert int(got_n) == int(want_n) == 8
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("transpose,vocab_chunk", [(False, None), (True, None),
                                                   (True, 32), (False, 40)])
def test_fused_linear_cross_entropy_matches_jax(transpose, vocab_chunk):
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 40, 32)).astype(np.float32)
    w = (0.2 * rng.standard_normal((32, 96))).astype(np.float32)
    if transpose:
        w = np.ascontiguousarray(w.T)
    labels = rng.integers(0, 96, (2, 40))
    labels[1, 5:9] = losses.IGNORE_INDEX

    def jax_loss(h):
        return jax_losses.fused_linear_cross_entropy(
            h, jnp.asarray(w), jnp.asarray(labels), transpose_weight=transpose,
            chunk=32, vocab_chunk=vocab_chunk)[0]

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_(True)
    got, n_valid = losses.fused_linear_cross_entropy(
        h, torch.from_numpy(w), torch.from_numpy(labels),
        transpose_weight=transpose, chunk=32, vocab_chunk=vocab_chunk)
    assert int(n_valid) == 76
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    want_g = np.asarray(want_g)
    assert np.max(np.abs(h.grad.numpy() - want_g)) <= 1e-2 * np.max(
        np.abs(want_g))


# --------------------------------------------------------------- optimizers


def _grads(rng, shapes, scale):
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _run_port(tx, p0, grads_seq):
    params = [torch.from_numpy(p.copy()) for p in p0]
    state = tx.init(params)
    for grads in grads_seq:
        tx.step(params, [torch.from_numpy(g) for g in grads], state)
    return [p.numpy() for p in params]


def _run_optax(tx, p0, grads_seq):
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    for grads in grads_seq:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


@pytest.mark.parametrize("kind", ["adamw", "adamw_noclip", "adamw_cosine",
                                  "adamw_accum", "sgd_momentum"])
def test_optimizers_match_optax(kind):
    rng = np.random.default_rng(2)
    shapes = [(8, 4), (4, 16)]
    p0 = _grads(rng, shapes, 0.5)
    # large gradients, so global-norm clipping engages on some steps
    grads_seq = [_grads(rng, shapes, s) for s in (3.0, 0.01, 1.0, 0.2)]
    if kind == "adamw":
        port, ref = optim.adamw(1e-2), jax_optim.adamw(1e-2)
    elif kind == "adamw_noclip":
        port = optim.adamw(1e-2, clip_norm=None, weight_decay=1e-4)
        ref = optax.adamw(1e-2, weight_decay=1e-4)
    elif kind == "adamw_cosine":
        port = optim.adamw(schedules.cosine_with_warmup(1e-2, 4, 1))
        ref = jax_optim.adamw(jax_sched.cosine_with_warmup(1e-2, 4, 1))
    elif kind == "adamw_accum":
        port = optim.adamw(1e-2, grad_accum_steps=2)
        ref = jax_optim.adamw(1e-2, grad_accum_steps=2)
    else:
        port = optim.sgd(0.1, momentum=0.9, clip_norm=1.0)
        ref = jax_optim.sgd(0.1, momentum=0.9, clip_norm=1.0)
    got = _run_port(port, p0, grads_seq)
    want = _run_optax(ref, p0, grads_seq)
    for g, w, p in zip(got, want, p0):
        assert not np.allclose(w, p)  # the updates did something
        # each update is O(lr); f32 rounding in another order shows at
        # 1e-5 of it
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * 0.1)


def test_schedules_match_jax():
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    pairs = [
        (schedules.constant(3e-4), jax_sched.constant(3e-4)),
        (schedules.cosine_with_warmup(1e-3, 100, 10, 0.1),
         jax_sched.cosine_with_warmup(1e-3, 100, 10, 0.1)),
        (schedules.cosine_with_warmup(1e-3, 100),
         jax_sched.cosine_with_warmup(1e-3, 100)),
        (schedules.step_decay(1e-2, 10, 0.5), jax_sched.step_decay(1e-2, 10, 0.5)),
        (schedules.by_name("cosine", 2e-3, total_steps=60, warmup_steps=5),
         jax_sched.by_name("cosine", 2e-3, total_steps=60, warmup_steps=5)),
    ]
    for port, ref in pairs:
        got = [port(s) for s in steps]
        want = [float(ref(s)) for s in steps]
        # the reference evaluates in f32: near the end of the cosine its
        # rounding shows at 1e-6 of the peak rate
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 2e-3)
    with pytest.raises(ValueError):
        schedules.by_name("linear", 1e-3)
    with pytest.raises(ValueError):
        schedules.cosine_with_warmup(1e-3, 0)


def test_offload_opt_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        make_train_step(offload_opt=True)


# --------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def tokenizer():
    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer

    records = sft.self_cognition_records(16)
    texts = [sft.render_chatml(sft.to_chat_messages(r, "You are a bot."))
             for r in sft.substitute_placeholders(records, "Bot", "Team")]
    return BPETokenizer.train(
        texts, vocab_size=300, min_frequency=1,
        special_tokens=("[PAD]", "[UNK]", sft.IM_START, sft.IM_END))


def test_sft_arrays_identical_to_jax(tokenizer):
    records = sft.self_cognition_records(24, seed=3)
    assert records == jax_sft.self_cognition_records(24, seed=3)
    assert (sft.substitute_placeholders(records, "N", "A")
            == jax_sft.substitute_placeholders(records, "N", "A"))
    assert (sft.to_chat_messages(records[0], "sys")
            == jax_sft.to_chat_messages(records[0], "sys"))
    got = sft.build_sft_dataset(records, tokenizer, name="Bot",
                                author="Team", max_length=48)
    want = jax_sft.build_sft_dataset(records, tokenizer, name="Bot",
                                     author="Team", max_length=48)
    for field in ("input_ids", "attention_mask", "labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.labels == sft.IGNORE_INDEX).any()
    assert (got.labels != sft.IGNORE_INDEX).any()
    # a truncated text and one with no assistant turn
    texts = ["<|im_start|>user\nhi<|im_end|>", sft.render_chatml(
        sft.to_chat_messages(records[1], "s"))]
    got = sft.tokenize_for_sft(texts, tokenizer, max_length=12, pad_id=0)
    want = jax_sft.tokenize_for_sft(texts, tokenizer, max_length=12, pad_id=0)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)


# --------------------------------------------------------------------- peft


@pytest.fixture(scope="module")
def tiny_params():
    jmodel = JaxQwen3(jax_qwen3_config(64, n_layer=2, hidden_size=64,
                                       intermediate_size=128, head_dim=16))
    params = numpy_params(jmodel, seed=4)
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    return params, cfg, params_from_jax(jax.tree.map(np.asarray, params), cfg)


def test_lora_targets_init_and_report_match_jax(tiny_params):
    params, cfg, state = tiny_params
    lcfg = lora.LoRAConfig(r=4, alpha=8.0,
                           target_patterns=(r"attn/(q_proj|v_proj)",))
    jcfg = jax_lora.LoRAConfig(r=4, alpha=8.0,
                               target_patterns=(r"attn/(q_proj|v_proj)",))
    names = lora.target_paths(state, lcfg)
    assert [flax_path(n) for n in names] == jax_lora.target_paths(params, jcfg)
    gen = torch.Generator().manual_seed(0)
    tree = lora.init_lora(state, lcfg, gen)
    jtree = jax_lora.init_lora(params, jcfg, jax.random.PRNGKey(0))
    for name in names:
        ja = jtree[flax_path(name)]
        assert tree[name]["a"].shape == ja["a"].shape
        assert tree[name]["b"].shape == ja["b"].shape
        assert not tree[name]["b"].any() and tree[name]["a"].std() > 0.01
    assert (lora.trainable_report(state, tree)
            == jax_lora.trainable_report(params, jtree))
    assert lcfg.scaling == 2.0
    assert lora.LoRAConfig.from_dict(lcfg.to_dict()) == lcfg
    with pytest.raises(ValueError, match="no 2-D kernels"):
        lora.init_lora(state, lora.LoRAConfig(target_patterns=("nope",)))


def test_apply_merge_and_carry_lora_match_jax(tiny_params):
    params, cfg, state = tiny_params
    jcfg = jax_lora.LoRAConfig(r=4, alpha=8.0)
    rng = np.random.default_rng(5)
    jtree = {p: {"a": rng.standard_normal((64, 4)).astype(np.float32),
                 "b": rng.standard_normal((4, params[p.split("/")[0]]["attn"][
                     p.split("/")[2]]["kernel"].shape[1])).astype(np.float32)}
             for p in jax_lora.target_paths(params, jcfg)}
    carried = lora_from_jax(jtree, cfg)
    for p, ab in jtree.items():
        np.testing.assert_array_equal(carried[p.replace("block_", "blocks.")
                                              .replace("/", ".")]["a"].numpy(),
                                      ab["a"])
    want = jax_lora.apply_lora(params, jtree, jcfg)
    got = lora.merge_lora(state, carried, lora.LoRAConfig(r=4, alpha=8.0))
    for name, t in got.items():
        leaf = want
        for part in flax_path(name).split("/"):
            leaf = leaf[part]
        np.testing.assert_allclose(t.numpy(), np.asarray(leaf), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="names no kernel"):
        lora_from_jax({"block_9/attn/q_proj/kernel": jtree[next(iter(jtree))]},
                      cfg)


def test_quantize_base_and_memory_report_match_jax(tiny_params):
    params, cfg, state = tiny_params
    jq = jax_qlora.quantize_base(params, min_size=2048)
    got = qlora.quantize_base(state, min_size=2048)
    jq_flat = params_from_jax(jax.tree.map(np.asarray, jq), cfg)
    quantized = sorted(n for n, v in got.items() if isinstance(v, NF4Tensor))
    assert quantized == sorted(n for n, v in jq_flat.items()
                               if isinstance(v, NF4Tensor))
    assert "tok_embed.weight" not in quantized and len(quantized) == 14
    for n in quantized:
        np.testing.assert_array_equal(got[n].packed.numpy(),
                                      jq_flat[n].packed.numpy())
    assert (qlora.memory_report(state, got)
            == jax_qlora.memory_report(params, jq))


def test_quantize_base_int8_matches_jax_lowmem(tiny_params):
    """``fmt="int8"``: the W8A16 serving format of ``convert_hf``, as JAX
    ``quantize_base_lowmem(fmt="int8")`` (which the port does not need:
    eager quantization is leaf by leaf) quantizes the same kernels."""
    from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor

    params, cfg, state = tiny_params
    jq = jax_qlora.quantize_base_lowmem(params, min_size=2048, fmt="int8",
                                        cast_rest_above=None)
    got = qlora.quantize_base(state, min_size=2048, fmt="int8")
    jq_flat = params_from_jax(jax.tree.map(np.asarray, jq), cfg)
    quantized = sorted(n for n, v in got.items() if isinstance(v, Int8Tensor))
    assert quantized == sorted(n for n, v in jq_flat.items()
                               if isinstance(v, Int8Tensor))
    assert len(quantized) == 14
    for n in quantized:
        np.testing.assert_array_equal(got[n].q.numpy(), jq_flat[n].q.numpy())
        # one f32 ulp: XLA divides by 127 as a multiply by its reciprocal
        np.testing.assert_allclose(got[n].scale.numpy(),
                                   jq_flat[n].scale.numpy(), rtol=2**-23,
                                   atol=0)
    with pytest.raises(ValueError, match="fmt must be one of"):
        qlora.quantize_base(state, fmt="int4")


def _step_kernel_calls(monkeypatch, fmt: str, n_layer: int) -> dict:
    """Kernel calls of one remat QLoRA step over a ``fmt`` base, counted at
    the kernels' wrappers."""
    from llm_in_practise_tpu_torch.models.qwen3 import (
        Qwen3,
        init_params,
        qwen3_config,
    )
    from llm_in_practise_tpu_torch.ops import flash_attention as fa
    from llm_in_practise_tpu_torch.ops import int4_matmul as i4
    from llm_in_practise_tpu_torch.ops import int8_matmul as i8
    from llm_in_practise_tpu_torch.ops import nf4_matmul as nm
    from llm_in_practise_tpu_torch.peft.fused import QLoRAModel
    from llm_in_practise_tpu_torch.quant import int4, int8
    from llm_in_practise_tpu_torch.train.step import make_fused_ce_loss

    cfg = qwen3_config(128, n_layer=n_layer, remat=True, attn_impl="flash",
                       head_dim=64, tie_word_embeddings=True)
    gen = torch.Generator().manual_seed(0)
    quantizer = {"nf4": lambda st: qlora.quantize_base(st, min_size=1),
                 "int4": lambda st: {
                     n: int4.rtn_quantize(v, group_size=64)
                     if n.startswith("blocks.") and n.endswith(".kernel")
                     else v for n, v in st.items()},
                 "int8": lambda st: int8.quantize_tree(
                     st, lambda n, v: n.startswith("blocks.")
                     and n.endswith(".kernel"))}[fmt]
    state = quantizer(init_params(cfg, gen, device="cpu"))
    lcfg = lora.LoRAConfig()
    model = QLoRAModel(Qwen3(cfg, device="meta"), state,
                       lora.init_lora(state, lcfg, gen), lcfg, device="cpu")
    calls = dict.fromkeys(("fwd", "bwd", "flash_fwd", "flash_bwd"), 0)

    def counting(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    ops = {"nf4": nm, "int4": i4, "int8": i8}[fmt]
    monkeypatch.setattr(ops, "_forward", counting("fwd", ops._forward))
    backward = f"{fmt}_matmul_backward"
    monkeypatch.setattr(ops, backward,
                        counting("bwd", getattr(ops, backward)))
    monkeypatch.setattr(fa, "flash_forward",
                        counting("flash_fwd", fa.flash_forward))
    monkeypatch.setattr(fa, "flash_backward",
                        counting("flash_bwd", fa.flash_backward))
    x = torch.randint(0, 128, (2, 16), generator=gen)
    loss, _ = make_fused_ce_loss(chunk=16, vocab_chunk=64)(
        model, (x, x.roll(-1, 1)))
    loss.backward()
    return calls


def test_remat_step_kernel_calls_match_the_derived_counts(monkeypatch):
    """The per-step launch counts chip_smoke.py checks on the card, here
    counted at the kernels' wrappers: NF4 forward 13 per block (the remat
    recompute stops before down_proj, which saves no tensor), NF4
    backward 7 per block less layer 0's q/k/v, flash forward twice and
    backward once per block."""
    n_layer = 3
    assert _step_kernel_calls(monkeypatch, "nf4", n_layer) == {
        "fwd": 13 * n_layer, "bwd": 7 * n_layer - 3,
        "flash_fwd": 2 * n_layer, "flash_bwd": n_layer}


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_remat_step_kernel_calls_over_ptq_bases(monkeypatch, fmt):
    """The same derived counts over the PTQ int4 and int8 bases, whose
    forward and dx kernels (B6/B7, B8/B9) take the NF4 kernels' places."""
    n_layer = 3
    assert _step_kernel_calls(monkeypatch, fmt, n_layer) == {
        "fwd": 13 * n_layer, "bwd": 7 * n_layer - 3,
        "flash_fwd": 2 * n_layer, "flash_bwd": n_layer}


# ---------------------------------------------------------------------- CLI


def test_train_cli_runs_on_cpu_and_refuses_unported_flags(capsys, tmp_path):
    adapter = str(tmp_path / "adapter")
    assert train_cli.main(["--steps", "2", "--device", "cpu",
                           "--max_length", "32", "--batch_size", "2",
                           "--gradient-checkpointing",
                           "--adapter_dir", adapter]) == 0
    out = capsys.readouterr().out
    assert "step 1 | loss" in out and "trainable params" in out
    assert f"adapter saved -> {adapter}/adapter.msgpack" in out
    parser = train_cli.build_parser()
    # --model_dir and --adapter_dir are ported (tests/test_torch_generate.py
    # trains from an HF dir); --fsdp > 1 still raises
    train_cli.check_not_ported(parser.parse_args(
        ["--model_dir", "m", "--adapter_dir", "a"]))
    with pytest.raises(FileNotFoundError, match="config.json"):
        train_cli.main(["--model_dir", str(tmp_path / "m"), "--device", "cpu",
                        "--adapter_dir", adapter])
    with pytest.raises(NotImplementedError, match="item 14"):
        train_cli.main(["--fsdp", "2", "--device", "cpu"])
