"""Port parity: the JAX package's routing arguments in the port.

``flash_attention`` (``block_q``, ``block_k``, ``use_kernel``,
``xla_max_seq``), ``paged_decode_attention`` (``use_kernel``,
``xla_max_pages``), ``decode_attention``'s kernel branch (the grouped
plain version of the decode kernel), the crossover functions
``xla_path_max_seq`` / ``paged_xla_max_pages`` with their environment
overrides, and ``InferenceEngine(paged_attn_max_pages=)`` down to the
cache and the paged call.  Each route is held against the JAX call
with the same arguments on the same seeded numpy inputs (JAX on the
CPU: its kernel routes run Pallas in interpret mode).  Tolerance: fp32
1e-5 absolute (another reduction order; base-2 online softmax against
a one-pass natural-log one on the plain routes); the plain route's
gradients 1e-4 (fp32 sums of 24 products in another order).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.inference import kv_cache as jkv
from apex_tpu.ops import attention as jattn
from apex_tpu.ops import paged_attention as jpa
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu.transformer.testing import llama_model_provider
from apex_tpu_torch.inference import InferenceEngine, params_from_jax
from apex_tpu_torch.inference import kv_cache as tkv
from apex_tpu_torch.inference import models as tmodels
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops import paged_attention as tpa
from apex_tpu_torch.transformer.testing import LlamaConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401

ATOL = 1e-5


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32))


@pytest.mark.parametrize("fn,args", [
    ("flash_attention", ("block_q", "block_k", "use_kernel", "xla_max_seq")),
    ("decode_attention", ("use_kernel", "xla_max_seq")),
    ("paged_decode_attention", ("use_kernel", "xla_max_pages")),
    ("init_paged_cache", ("attn_max_pages",)),
    ("InferenceEngine", ("paged_attn_max_pages",)),
])
def test_every_routing_argument_is_accepted(fn, args):
    """The port's signatures carry the JAX entries' routing arguments,
    keyword-only where JAX has them keyword-only, with JAX's defaults."""
    mods = {"flash_attention": (jattn, tattn), "decode_attention":
            (jattn, tattn), "paged_decode_attention": (jpa, tpa),
            "init_paged_cache": (jkv, tkv)}
    if fn == "InferenceEngine":
        jsig = inspect.signature(JaxEngine.__init__).parameters
        tsig = inspect.signature(InferenceEngine.__init__).parameters
    else:
        jmod, tmod = mods[fn]
        jsig = inspect.signature(getattr(jmod, fn)).parameters
        tsig = inspect.signature(getattr(tmod, fn)).parameters
    for name in args:
        assert name in jsig and name in tsig, name
        assert tsig[name].kind == jsig[name].kind, name
        assert tsig[name].default == jsig[name].default, name


FLASH_ROUTES = {
    "use_kernel=False": dict(use_kernel=False),
    "use_kernel=True": dict(use_kernel=True),
    "auto": dict(),
    "block_q": dict(block_q=128),
    "block_k": dict(block_k=128),
    "xla_max_seq=0": dict(xla_max_seq=0),
    "xla_max_seq=4096": dict(xla_max_seq=4096),
}


@pytest.mark.parametrize("route", list(FLASH_ROUTES))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_flash_attention_routes_match_jax(route, masked):
    """Each routing argument against the JAX entry with the same
    arguments: causal, GQA-free [2, 3, 24, 40] with (or without) a
    per-batch mask holding a fully masked row; nothing launches on the
    CPU."""
    kw = FLASH_ROUTES[route]
    q, k, v = _qkv(2, 3, 24, 40, 16, seed=31)
    mask = None
    if masked:
        mask = np.random.RandomState(32).rand(2, 1, 24, 40) > 0.6
        mask[:, :, 5] = True
    ref = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True,
        mask=None if mask is None else jnp.asarray(mask), **kw))
    _build.reset_launch_counts()
    got = tattn.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert not any(_build.launch_counts().values())
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=ATOL)
    if masked:
        assert np.all(got.detach().numpy()[:, :, 5] == 0)


def test_plain_route_is_differentiable_with_a_mask_as_in_jax():
    """``use_kernel=False`` is plain PyTorch: autograd gives the JAX XLA
    route's gradients, mask included (the kernels' masked backward is
    not ported yet and raises)."""
    q, k, v = _qkv(1, 2, 24, 24, 16, seed=33)
    mask = np.random.RandomState(34).rand(1, 1, 24, 24) > 0.7
    mask[..., 2, :] = True
    jm = jnp.asarray(mask)

    def loss(q_, k_, v_):
        return jnp.sum(jattn.flash_attention(q_, k_, v_, causal=True,
                                             mask=jm, use_kernel=False) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=True,
                                mask=torch.from_numpy(mask), use_kernel=False)
    (out ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    with pytest.raises(NotImplementedError, match="mask operand"):
        tattn.flash_attention(tq, tk, tv, causal=True,
                              mask=torch.from_numpy(mask)).sum().backward()


@pytest.mark.parametrize("block", [0, -128, 1.5, True])
def test_block_sizes_are_checked(block):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 8, seed=35))
    for name in ("block_q", "block_k"):
        with pytest.raises(ValueError, match=f"{name} must be a positive"):
            tattn.flash_attention(q, k, v, **{name: block})


def _decode_case(b, h, kvh, s, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, 1, d).astype(np.float32)
    k = rng.randn(b, kvh, s, d).astype(np.float32)
    v = rng.randn(b, kvh, s, d).astype(np.float32)
    lengths = np.asarray([0, 1, s // 2, s - 1, s][:b], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("route", ["use_kernel=False", "use_kernel=True",
                                   "xla_max_seq=0", "xla_max_seq=64"])
@pytest.mark.parametrize("kvh", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_decode_attention_routes_match_jax(route, kvh):
    """``decode_attention`` on each route against JAX's: the plain
    grouped chain, and the kernel branch, whose port on the CPU is the
    decode kernel's grouped plain version (the JAX branch broadcasts k/v
    and runs the Pallas masked flash kernel); lengths 0, 1, S/2, S-1, S;
    nothing launches."""
    kw = {"use_kernel=False": dict(use_kernel=False),
          "use_kernel=True": dict(use_kernel=True),
          "xla_max_seq=0": dict(xla_max_seq=0),
          "xla_max_seq=64": dict(xla_max_seq=64)}[route]
    q, k, v, lengths = _decode_case(5, 4, kvh, 40, 16, seed=kvh + 40)
    ref = np.asarray(jattn.decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), **kw))
    _build.reset_launch_counts()
    got = tattn.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)), **kw).numpy()
    assert not any(_build.launch_counts().values())
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.all(got[0] == 0)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_kernel_plain_version_on_a_strided_layer_view(group):
    """The decode kernel's plain version reads one layer of a
    ``[slots, layers, kv_heads, S, d]`` cache through its strided view
    (no copy) and equals JAX's kernel branch on that layer; bf16 within
    one bf16 ulp of the output's magnitude (both round p to bf16 for
    P·V and the output once)."""
    b, kvh, layers, s, d = 5, 2, 3, 70, 16
    rng = np.random.RandomState(group)
    q = rng.randn(b, kvh * group, d).astype(np.float32)
    ck = rng.randn(b, layers, kvh, s, d).astype(np.float32)
    cv = rng.randn(b, layers, kvh, s, d).astype(np.float32)
    lengths = np.asarray([0, 1, 64, 65, 70], np.int32)
    layer = 1
    ref = jattn.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(ck[:, layer], jnp.bfloat16),
        jnp.asarray(cv[:, layer], jnp.bfloat16), jnp.asarray(lengths),
        use_kernel=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tk = torch.from_numpy(ck).to(torch.bfloat16)
    tv = torch.from_numpy(cv).to(torch.bfloat16)
    view_k, view_v = tk[:, layer], tv[:, layer]
    assert not view_k.is_contiguous()
    got = tattn.decode_attention(torch.from_numpy(q).to(torch.bfloat16),
                                 view_k, view_v, torch.from_numpy(lengths),
                                 use_kernel=True).float().numpy()
    atol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert np.all(got[0] == 0)


def _paged_case(seed, slots=4, h=4, kvh=2, d=16, ps=8, mpps=5, layers=2):
    rng = np.random.RandomState(seed)
    n_pages = slots * mpps
    shape = (n_pages + 1, layers, kvh, ps, d)
    pk = rng.randn(*shape).astype(np.float32)
    pv = rng.randn(*shape).astype(np.float32)
    lengths = np.asarray([0, 1, ps + 1, mpps * ps][:slots], np.int32)
    perm = rng.permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for i, n in enumerate(lengths):
        need = -(-int(n) // ps)
        table[i, :need] = perm[cursor:cursor + need]
        cursor += need
    q = rng.randn(slots, h, d).astype(np.float32)
    return q, pk[:, 1], pv[:, 1], table, lengths


@pytest.mark.parametrize("kw", [
    dict(use_kernel=False), dict(use_kernel=True), dict(),
    dict(xla_max_pages=0), dict(xla_max_pages=64),
    dict(use_kernel=False, xla_max_pages=0)],
    ids=["use_kernel=False", "use_kernel=True", "auto", "xla_max_pages=0",
         "xla_max_pages=64", "use_kernel=False+xla_max_pages=0"])
def test_paged_decode_routes_match_jax(kw):
    """``paged_decode_attention`` with the JAX entry's arguments against
    the JAX call with the same ones: the gathered route through
    ``decode_attention(use_kernel=False)`` and the kernel route (the
    Pallas kernel in interpret mode on the JAX side; ``xla_max_pages=64``
    sends this 5-page window to JAX's gathered route, the port keeps its
    kernel: the same function)."""
    q, kp, vp, table, lengths = _paged_case(50)
    ref = np.asarray(jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lengths)), **kw))
    _build.reset_launch_counts()
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)),
        **kw).numpy()
    assert not any(_build.launch_counts().values())
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.all(got[0] == 0)


@pytest.mark.parametrize("name,env,default", [
    ("xla_path_max_seq", "APEX_TPU_ATTN_XLA_MAX_SEQ", 256),
    ("paged_xla_max_pages", "APEX_TPU_PAGED_XLA_MAX_PAGES", 64),
    ("decode_xla_max_seq", "APEX_TPU_DECODE_XLA_MAX_SEQ", 4096)])
def test_crossover_functions_behave_like_jax(monkeypatch, name, env,
                                             default):
    jmod = jpa if name == "paged_xla_max_pages" else jattn
    tmod = tpa if name == "paged_xla_max_pages" else tattn
    jfn, tfn = getattr(jmod, name), getattr(tmod, name)
    monkeypatch.delenv(env, raising=False)
    assert tfn() == jfn() == default
    assert tfn(7) == jfn(7) == 7
    monkeypatch.setenv(env, "17")
    assert tfn() == jfn() == 17
    assert tfn(3) == jfn(3) == 3                # the override beats the env
    monkeypatch.setenv(env, "")
    assert tfn() == jfn() == default
    monkeypatch.setenv(env, "x")
    for fn in (jfn, tfn):
        with pytest.raises(ValueError, match=f"{env} must be an int"):
            fn()
    assert tfn(5) == jfn(5) == 5                # an override skips the env


@pytest.mark.parametrize("entry", ["flash", "paged"])
def test_a_bad_crossover_env_raises_in_the_entry_as_in_jax(monkeypatch,
                                                           entry):
    """The auto route reads the crossover, so a malformed env value
    raises in both entries; an explicit route (or block size) does
    not read it."""
    if entry == "flash":
        monkeypatch.setenv("APEX_TPU_ATTN_XLA_MAX_SEQ", "x")
        q, k, v = _qkv(1, 2, 8, 8, 8, seed=36)
        calls = [(jattn.flash_attention, tuple(map(jnp.asarray, (q, k, v)))),
                 (tattn.flash_attention,
                  tuple(map(torch.from_numpy, (q, k, v))))]
        ok = [dict(use_kernel=True), dict(use_kernel=False),
              dict(block_q=128)]
    else:
        monkeypatch.setenv("APEX_TPU_PAGED_XLA_MAX_PAGES", "x")
        case = _paged_case(51)
        calls = [(jpa.paged_decode_attention,
                  tuple(map(jnp.asarray, case))),
                 (tpa.paged_decode_attention,
                  tuple(map(torch.from_numpy, case)))]
        ok = [dict(use_kernel=True), dict(use_kernel=False),
              dict(xla_max_pages=4)]
    for fn, args in calls:
        with pytest.raises(ValueError, match="must be an int"):
            fn(*args)
        for kw in ok:
            fn(*args, **kw)


CFG = dict(vocab_size=256, hidden_size=64, num_layers=2,
           num_attention_heads=4, num_kv_heads=2, ffn_hidden_size=128,
           max_seq_length=64)
PAGED = dict(slots=2, max_seq=64, page_size=16, num_pages=8)


@pytest.fixture(scope="module")
def llama():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = JaxLlamaConfig(**CFG)
    jparams = llama_model_provider(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    cfg = LlamaConfig(**CFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_jax("llama", cfg, tree,
                                               device="cpu")


@pytest.mark.parametrize("max_pages", [None, 0, 3])
def test_engine_passes_paged_attn_max_pages_to_the_cache_and_the_call(
        llama, monkeypatch, max_pages):
    """``InferenceEngine(paged_attn_max_pages=)`` lands on the cache, as
    in JAX, and every paged attention call of a decode step receives it
    as ``xla_max_pages``; the decode logits equal the JAX engine's with
    the same argument."""
    jcfg, jparams, cfg, tparams = llama
    je = JaxEngine("llama", jcfg, jparams, cache_dtype=jnp.float32,
                   paged_attn_max_pages=max_pages, **PAGED)
    te = InferenceEngine("llama", cfg, tparams, cache_dtype=torch.float32,
                         device="cpu", paged_attn_max_pages=max_pages,
                         **PAGED)
    assert te.paged_attn_max_pages == je.paged_attn_max_pages == max_pages
    jc, tc = je.init_cache(), te.init_cache()
    assert tc.attn_max_pages == jc.attn_max_pages == max_pages
    seen = []
    real = tmodels.paged_decode_attention

    def spy(*args, **kw):
        seen.append(kw.get("xla_max_pages", "missing"))
        return real(*args, **kw)

    monkeypatch.setattr(tmodels, "paged_decode_attention", spy)
    ja, ta = je.new_allocator(), te.new_allocator()
    prompt = [3, 1, 4, 1, 5, 9, 2]
    need = ja.pages_needed(len(prompt) + 2)
    jpages, tpages = ja.acquire(need), ta.acquire(need)
    jc, jt, _ = je.prefill(jc, prompt, 0, pages=jpages)
    tc, tt, _ = te.prefill(tc, prompt, 0, pages=tpages)
    last = np.asarray([int(jt), 0], np.int32)
    jc, _, jlog, _ = je.decode(jc, last)
    tc, _, tlog, _ = te.decode(tc, last)
    assert seen == [max_pages] * CFG["num_layers"]
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)


def test_dense_engine_and_cache_defaults(llama):
    """A dense engine has no paged crossover; a pool built without one
    keeps None, as in JAX."""
    _, _, cfg, tparams = llama
    te = InferenceEngine("llama", cfg, tparams, device="cpu", slots=1,
                         max_seq=64, paged_attn_max_pages=3)
    assert te.paged_attn_max_pages is None
    assert tkv.init_paged_cache(2, 1, 1, 4, 8, slots=1,
                                max_pages_per_slot=2,
                                device="cpu").attn_max_pages is None
    assert jkv.init_paged_cache(2, 1, 1, 4, 8, slots=1,
                                max_pages_per_slot=2).attn_max_pages is None
    assert tkv.init_paged_cache(2, 1, 1, 4, 8, slots=1, max_pages_per_slot=2,
                                attn_max_pages=5,
                                device="cpu").attn_max_pages == 5
