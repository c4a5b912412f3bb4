"""The width of the port's attention kernels, on the CPU: the one route
(``attention._flash_route``, ``paged_attention._paged_route``) over
dtype x head dim x mask x rate and the paged pool's group x head dim x
page x dtype; the zero-padding of bf16 head dims in front of the
instances; and ``flash_attention``, ``paged_decode_attention``,
``decode_attention``, a GPT with head dim 80 (serving and a training
step) and an fp32 BERT training step against the JAX package on the
same seeded numpy inputs (the JAX kernels in Pallas interpret mode).

Tolerances: fp32 1e-5 absolute for flash outputs and grads (fp32 on
both sides, the JAX kernels' blockwise online softmax against one
pass), 2e-5 for paged and dense decode (as ``test_torch_paged_attention``
holds them), 1e-4 for the GPT logits (as ``test_torch_gpt_serving``)
and 1e-5 for the training steps' loss and grads (as
``test_torch_lm_training``).  bf16: each output within 2^-6 of its
largest magnitude -- a few bf16 ulps: both sides round p for P.V, ds
for the products and every output to bf16, at different points (the
JAX kernels against a running block maximum).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.ops import attention as jattn
from apex_tpu.ops.paged_attention import paged_decode_attention as jpaged
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import BertConfig as JaxBertConfig
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import bert_model_provider as jax_bert
from apex_tpu.transformer.testing import gpt_model_provider as jax_gpt
from apex_tpu_torch.inference import InferenceEngine, params_from_jax
from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.transformer.testing import (BertConfig, GPTConfig,
                                                bert_model_provider,
                                                gpt_model_provider)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

# by module name: the package re-exports the function of the same name
tpa = importlib.import_module("apex_tpu_torch.ops.paged_attention")

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
_HEAD_DIMS = [16, 32, 48, 64, 80, 96, 128, 160, 256, 320]
_MD = [(False, 0.0), (True, 0.0), (False, 0.1), (True, 0.1)]
_ATOL = 1e-5
_BF16_REL = 2.0 ** -6


@pytest.fixture(autouse=True)
def _tp1():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    yield


# -- the route -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("d", _HEAD_DIMS)
@pytest.mark.parametrize("masked,rate", _MD)
def test_flash_route_table(dtype, d, masked, rate):
    """Every head dim up to 256 maps to a kernel: bf16 up to 128 to the
    next instance head dim (64 and 128 only with a mask or dropout), the
    rest to the wide family at its own d; past 256 raises, naming V9."""
    if d > 256:
        with pytest.raises(ValueError, match="V9"):
            tattn._flash_route(dtype, d, masked, rate)
        return
    family, dp = tattn._flash_route(dtype, d, masked, rate)
    if dtype == BF16 and d <= 128:
        dims = tattn._MD_HEAD_DIMS if masked or rate \
            else tattn._KERNEL_HEAD_DIMS
        assert family == "instance" and dp == min(x for x in dims if x >= d)
        # a padded call routes to itself: forward and backward agree
        assert tattn._flash_route(dtype, dp, masked, rate) == (family, dp)
    else:
        assert (family, dp) == ("wide", d)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("group", [1, 2, 3, 8, 16, 32, 48])
@pytest.mark.parametrize("d", [64, 80, 128, 256, 320])
@pytest.mark.parametrize("ps", [8, 16, 48, 128, 256])
def test_paged_route_table(dtype, group, d, ps):
    """Every pool up to head dim 256 maps to a kernel: the instance for
    its bf16 shapes, #7w for the rest; past 256 raises, naming V9, and
    the engine's build-time check follows the route."""
    if d > 256:
        with pytest.raises(ValueError, match="V9"):
            tpa._paged_route(dtype, dtype, group, d, ps)
        with pytest.raises(ValueError, match="V9"):
            tpa.check_kernel_page_size(ps, group=group, head_dim=d,
                                       dtype=dtype)
        return
    inst = dtype == BF16 and group in (1, 2, 4, 8) and d in (64, 128) \
        and ps in (16, 32, 64, 128)
    assert tpa._paged_route(dtype, dtype, group, d, ps) == (
        "paged_attention" if inst else "paged_attention_wide")
    tpa.check_kernel_page_size(ps, group=group, head_dim=d, dtype=dtype)
    # an fp32 query against a bf16 pool takes #7w (it reads q in fp32)
    assert tpa._paged_route(F32, BF16, group, d, ps) == \
        "paged_attention_wide"


def _spy_routes(monkeypatch):
    seen = []
    route = tattn._flash_route

    def spy(dtype, d, masked, rate):
        out = route(dtype, d, masked, rate)
        seen.append(((dtype, d, masked, rate), out))
        return out

    monkeypatch.setattr(tattn, "_flash_route", spy)
    return seen


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [48, 80, 256])
@pytest.mark.parametrize("masked,rate", _MD)
def test_forward_and_backward_take_one_route(monkeypatch, dtype, d, masked,
                                             rate):
    """The forward and the backward ask the one predicate with the same
    arguments and get the same answer; a padded call reaches both at the
    instance's head dim, and the output and grads keep the real one."""
    seen = _spy_routes(monkeypatch)
    q, k, v = (torch.randn(1, 2, 24, d, generator=torch.Generator()
                           .manual_seed(i)).to(dtype).requires_grad_()
               for i in range(3))
    mask = torch.zeros(1, 1, 24, 24, dtype=torch.bool)
    mask[..., 20:] = True
    out = tattn.flash_attention(q, k, v, causal=not masked,
                                mask=mask if masked else None,
                                dropout_rate=rate, dropout_seed=3)
    out.float().sum().backward()
    assert out.shape == q.shape and q.grad.shape == q.shape
    entry, fwd, bwd = seen
    assert entry[0] == (dtype, d, masked, rate)
    assert fwd == bwd
    assert fwd[0][1] == entry[1][1]            # the padded (or real) d


def test_split_gate_reads_the_real_head_dim(monkeypatch):
    """bf16 d 80 runs at 128; with the gate at exactly sq * 80 * 4 bytes
    the real head dim keeps the one-pass route (as JAX's gate reads the
    unpadded d), where the padded one would have taken the split pair;
    one byte lower, the split pair."""
    sq, d = 40, 80
    gates = []
    split = tattn._split_bwd
    monkeypatch.setattr(tattn, "_split_bwd", lambda s, hd: (
        gates.append((s, hd, split(s, hd))), split(s, hd))[1])
    q = torch.randn(1, 2, sq, d).to(BF16).requires_grad_()
    for limit, want in ((sq * d * 4, False), (sq * d * 4 - 1, True)):
        monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", limit)
        gates.clear()
        tattn.flash_attention(q, q, q, causal=True).float().sum().backward()
        assert gates == [(sq, d, want)]


def test_padding_matches_the_unpadded_plain_version():
    """The padded route gives the unpadded plain version's numbers: zero
    columns add nothing to a score and come out as zero columns (within
    one bf16 rounding of the largest value, should the matmul sum the
    longer rows in another order)."""
    d = 80
    q, k, v, do = (torch.randn(2, 3, 33, d, generator=torch.Generator()
                               .manual_seed(10 + i)).to(BF16)
                   for i in range(4))
    scale = d ** -0.5
    q3, k3, v3, do3 = (t.reshape(6, 33, d) for t in (q, k, v, do))
    ref, lse = tattn._fwd_reference(q3, k3, v3, True, scale)
    want = tattn._bwd_reference(q3, k3, v3, ref, lse, do3, True, scale)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = tattn.flash_attention(qs, ks, vs, causal=True)
    out.backward(do)
    for g, w in zip((out, qs.grad, ks.grad, vs.grad), (ref, *want)):
        assert g.dtype == BF16
        torch.testing.assert_close(
            g.reshape(6, 33, d).float(), w.float(), rtol=0,
            atol=2.0 ** -8 * w.float().abs().max().item())


# -- flash_attention against JAX -------------------------------------------

def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _jax_run(q, k, v, do, dtype, **kw):
    jd = jnp.float32 if dtype == F32 else jnp.bfloat16
    out, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(a, b_, c, **kw),
                       *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, jd))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _torch_run(q, k, v, do, dtype, **kw):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*ts, **kw)
    out.backward(torch.from_numpy(do).to(dtype))
    assert out.dtype == dtype
    return [t.detach().float().numpy() for t in (out, *(x.grad for x in ts))]


def _close(got, want, dtype, atol=_ATOL):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        tol = atol if dtype == F32 else _BF16_REL * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [48, 80, 256])
@pytest.mark.parametrize("case", ["causal", "masked", "dropout"])
def test_flash_attention_wide_head_dims_match_jax(dtype, d, case):
    """Forward and grads at head dims 48, 80 and 256: causal with the
    offset sk - sq, a per-batch mask with a fully masked row, dropout
    with the same keep mask; bf16 below 128 through the padded route."""
    b, h, sq, sk = 2, 2, 24, 40
    q, k, v, do = _inputs(b, h, sq, sk, d, d)
    kw = dict(causal=case != "masked")
    if case == "masked":
        m = np.random.RandomState(d).rand(b, 1, sq, sk) > 0.6
        m[:, :, 3] = True
        kw["mask"] = m
    if case == "dropout":
        kw.update(dropout_rate=0.2, dropout_seed=-4321)
    jkw = dict(kw, mask=None if "mask" not in kw else jnp.asarray(kw["mask"]))
    tkw = dict(kw, mask=None if "mask" not in kw
               else torch.from_numpy(kw["mask"]))
    _close(_torch_run(q, k, v, do, dtype, **tkw),
           _jax_run(q, k, v, do, dtype, **jkw), dtype)


# -- paged and dense decode against JAX ------------------------------------

def _pool(slots, kvh, group, d, ps, mpps, lengths, seed):
    rng = np.random.RandomState(seed)
    need = [min(-(-n // ps), mpps) for n in lengths]
    n_pages = sum(need)
    shape = (n_pages + 1, 2, kvh, ps, d)
    pk, pv = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    perm = rng.permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(need):
        table[s, :n] = perm[cursor:cursor + n]
        cursor += n
    q = rng.randn(slots, kvh * group, d).astype(np.float32)
    return q, pk, pv, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("group", [3, 16])
@pytest.mark.parametrize("d", [80, 256])
@pytest.mark.parametrize("ps", [8, 48])
def test_paged_decode_wide_shapes_match_jax(group, d, ps):
    """fp32 pools at groups 3 and 16, head dims 80 and 256, pages 8 and
    48 (the shapes #7w takes), one layer's strided view; lengths 0, on a
    page edge, across it and the whole window."""
    mpps = 4
    lengths = [0, ps, ps + 1, mpps * ps]
    q, pk, pv, table, lens = _pool(4, 2, group, d, ps, mpps, lengths, d + ps)
    ref = jpaged(jnp.asarray(q), jnp.asarray(pk[:, 1]),
                 jnp.asarray(pv[:, 1]), jnp.asarray(table),
                 jnp.asarray(lens), use_kernel=True)
    tk, tv = torch.from_numpy(pk)[:, 1], torch.from_numpy(pv)[:, 1]
    got = tpa.paged_decode_attention(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(table),
                                     torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
    assert np.all(got.numpy()[0] == 0)


@pytest.mark.parametrize("group", [3, 16])
@pytest.mark.parametrize("d", [80, 256])
def test_decode_attention_wide_shapes_match_jax(group, d):
    """The dense cache's kernel branch at groups and head dims the decode
    kernel lacks (on the card: the JAX branch onto #3w), fp32."""
    rng = np.random.RandomState(group + d)
    b, kvh, s = 3, 2, 40
    q = rng.randn(b, kvh * group, d).astype(np.float32)
    k, v = (rng.randn(b, kvh, s, d).astype(np.float32) for _ in range(2))
    lens = np.asarray([0, 17, 40], np.int32)
    ref = jattn.decode_attention(*(jnp.asarray(x) for x in (q, k, v, lens)),
                                 use_kernel=True)
    got = tattn.decode_attention(*(torch.from_numpy(x)
                                   for x in (q, k, v, lens)),
                                 use_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)


# -- a GPT with head dim 80, an fp32 BERT ----------------------------------

GPT80 = dict(vocab_size=128, hidden_size=160, ffn_hidden_size=320,
             num_layers=2, num_attention_heads=2, max_seq_length=64,
             hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def gpt80():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = JaxGPTConfig(**GPT80)
    jparams = jax_gpt(jcfg).init(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = GPTConfig(**GPT80)
    return jcfg, jparams, cfg, tree


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_gpt_head_dim_80_serves_as_jax(gpt80, layout):
    """GPT with two heads of 80: ``generate`` on fp32 paged (page 8, a
    size the instance lacks) and dense caches equals the JAX engine's
    tokens."""
    jcfg, jparams, cfg, tree = gpt80
    geo = dict(slots=2, max_seq=64)
    if layout == "paged":
        geo.update(page_size=8, num_pages=24)
    je = JaxEngine("gpt", jcfg, jparams, cache_dtype=jnp.float32,
                   **geo, **(dict(paged_attn_max_pages=0)
                             if layout == "paged" else {}))
    te = InferenceEngine("gpt", cfg, params_from_jax("gpt", cfg, tree,
                                                     device="cpu"),
                         cache_dtype=torch.float32, device="cpu", **geo)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in (5, 19, 33)]
    assert te.generate(prompts, max_new_tokens=6) == [
        [int(t) for t in o] for o in je.generate(prompts, max_new_tokens=6)]


def _tree_grads(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_tree_grads(val, prefix + (key,)))
        else:
            out[".".join(prefix + (key,))] = np.asarray(val)
    return out


def _assert_grads(tm, jgrads):
    want = _tree_grads(jgrads["params"])
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=_ATOL,
                                   err_msg=name)


def test_gpt_head_dim_80_training_step_matches_jax(gpt80):
    """One fp32 forward and backward of the head-dim-80 GPT (params from
    the JAX tree): loss and every grad as the JAX model's."""
    jcfg, jparams, cfg, tree = gpt80
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 128, size=(2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_gpt(jcfg).apply(
        p, toks, labels))(jparams)
    tm = gpt_model_provider(cfg, device="cpu")
    load_jax_params(tm, tree)
    _build.reset_launch_counts()
    loss = tm(torch.from_numpy(toks), torch.from_numpy(labels))
    loss.backward()
    assert not any(_build.launch_counts().values())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=_ATOL)
    _assert_grads(tm, jgrads)


def test_fp32_bert_training_step_matches_jax():
    """``BertConfig``'s default fp32 parameters at head dim 80 with a
    padding mask: loss and every grad as the JAX model's."""
    cfg_kw = dict(GPT80, vocab_size=128)
    jcfg = JaxBertConfig(**cfg_kw)
    cfg = BertConfig(**cfg_kw)
    assert cfg.params_dtype == torch.float32
    z = jnp.zeros((1, 8), jnp.int32)
    jparams = jax_bert(jcfg).init(jax.random.PRNGKey(6), z, z)
    rng = np.random.RandomState(7)
    b, s = 2, 24
    toks = rng.randint(0, 128, size=(b, s)).astype(np.int32)
    types = rng.randint(0, 2, size=(b, s)).astype(np.int32)
    pad = np.ones((b, s), np.int32)
    pad[1, 15:] = 0
    labels = rng.randint(0, 128, size=(b, s)).astype(np.int32)
    lm = ((rng.rand(b, s) < 0.3) * pad).astype(np.float32)
    lm[0, 0] = 1.0
    jloss, jgrads = jax.value_and_grad(lambda p: jax_bert(jcfg).apply(
        p, toks, types, attention_mask=pad, lm_labels=labels,
        loss_mask=lm)[0])(jparams)
    tm = bert_model_provider(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jparams))
    loss, _ = tm(*(torch.from_numpy(a) for a in (toks, types, pad, labels)),
                 loss_mask=torch.from_numpy(lm))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=_ATOL)
    _assert_grads(tm, jgrads)


# -- the build -------------------------------------------------------------

_WIDE = {"flash_wide.cu": ("flash_attention_wide", "flash_attention_wide_dq",
                           "flash_attention_wide_dkv"),
         "paged_wide.cu": ("paged_attention_wide",)}


@pytest.mark.parametrize("source", sorted(_WIDE))
def test_the_wide_sources_and_counters_are_built(source):
    """Each wide source exists, ``SOURCES`` names its kernels' counters
    (``KERNELS`` maps them back), each C entry has a signature and is
    exported by the source, and the shared header is hashed."""
    text = (_build.CSRC / source).read_text()
    assert set(_build.SOURCES[source]) == set(_WIDE[source])
    for name in _WIDE[source]:
        assert _build.KERNELS[name] == source
        entry = _build.SOURCES[source][name]
        assert entry in _build._SIGNATURES
        assert f'extern "C" int {entry}(' in text
    assert '#include "wide.cuh"' in text
    assert "wide.cuh" in _build._digest_files()


def test_chip_smoke_runs_the_width_phase_by_default():
    """The card script's default phases include ``width``, after the
    train-check, and its records name the four wide counters."""
    import ast
    from pathlib import Path
    text = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    defaults = [kw.value.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) for kw in node.keywords
                if kw.arg == "default" and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--phases"]
    phases = defaults[0].split(",")
    assert "width" in phases
    assert phases.index("width") > phases.index("train-check")
    for name in sum(_WIDE.values(), ()):
        assert f'"{name}"' in text
