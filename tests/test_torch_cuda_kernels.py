"""The port's CUDA kernels against their plain PyTorch versions, on the
card, over the shapes and options the main paths do not reach (other
head dims and query groups, small pages, q/k lengths that differ,
padded validity windows, the fp32 LayerNorm paths, LayerNorm's
backward, odd flat lengths and offset views for the unscale, Adam, the
L2 norm, LAMB's phase 1, SGD and Adagrad, the L2 norm's run-to-run
repeatability, the LAMB rule against its plain route, axpby and the
fused scale and norm with the ``multi_tensor_applier`` shim over them,
the split flash backward's two kernels and its route, the masked flash
forward over per-batch, per-head, shared and key-only masks with fully
masked rows, causal offsets and ragged windows, and over masks with
dead, full and partly dead tiles and dead query blocks (and
``decode_attention``'s kernel branch against its plain chain, the
decode kernel on a strided cache layer at every query group and head
dim with no broadcast allocated), paged
decode over
every query group, head dim and page size with lengths on and across
page and split edges, 8192-position windows and 1 to 256 slots (two
calls the same bits), the norm backward on both sides of its
register/multi-pass line, the flash forward
and all three flash backward kernels at lengths and windows that cut
their tiles (causal rows that see no key among them), the
fused decode block's query groups, head dims, edge lengths, slot
groups and its attention-only variant, and its GPT instance over the
same edges; the optimizer classes: each
twin's and tree class's launches per step with no host sync, and a
twin step equal to a functional step bit for bit).

A CUDA kernel has no CPU mode, so every test here takes the ``cuda``
fixture and skips without a card.  On a machine with one (the package's
JAX reference is not needed, nor the repo's test ``conftest.py``)::

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: bf16 outputs within 2e-2 absolute (unit-scale inputs; both
sides compute in fp32 and round p and the output to bf16, in a
different order); base-2 lse within 1e-3; norms within 2^-6 of the
output's magnitude (a few bf16 ulps).
"""
import importlib

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as attn
from apex_tpu_torch.ops import paged_attention as pa

# by module name: the package re-exports a function called layer_norm
ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(100, 100), (40, 200), (130, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, d, sq, sk, causal):
    q, k, v = (_randn((3, s, d), seed, cuda)
               for seed, s in ((1, sq), (2, sk), (3, sk)))
    before = _build.launch_counts()["flash_attention"]
    out, lse = attn._fwd(q, k, v, causal, d ** -0.5)
    assert _build.launch_counts()["flash_attention"] == before + 1
    ref_out, ref_lse = attn._fwd_reference(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_kernel_validity_window_and_offset(cuda):
    """A padded bucket (90 real of 128 rows and columns) with an
    explicit causal offset: padded rows emit 0 and lse -1e30."""
    q, k, v = (_randn((2, 128, 64), seed, cuda) for seed in (4, 5, 6))
    out, lse = attn._fwd(q, k, v, True, 0.125, causal_off=0,
                         valid=(90, 90))
    ref_out, ref_lse = attn._fwd_reference(q, k, v, True, 0.125,
                                           causal_off=0, valid=(90, 90))
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert bool((out[:, 90:] == 0).all())


# -- the forward across its tiles ----------------------------------------
#
# Lengths that cut the forward's 128-query blocks and its key tiles (1,
# 2, 63, 65, 127, 129, 1000, sk 17 under 200 queries), causal sq > sk
# (the leading rows see no key: 0 and lse -1e30), and validity windows
# that end inside a tile; out and lse with the limits above.

def _fwd_case(cuda, bh, sq, sk, d, causal, seed, causal_off=None,
              valid=None):
    q, k, v = (_randn((bh, s, d), seed + i, cuda)
               for i, s in enumerate((sq, sk, sk)))
    before = _build.launch_counts()["flash_attention"]
    out, lse = attn._fwd(q, k, v, causal, d ** -0.5, causal_off=causal_off,
                         valid=valid)
    assert _build.launch_counts()["flash_attention"] == before + 1
    ref_out, ref_lse = attn._fwd_reference(q, k, v, causal, d ** -0.5,
                                           causal_off=causal_off,
                                           valid=valid)
    torch.cuda.synchronize()
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    return out, lse


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(1, 1), (2, 2), (1, 1000), (63, 63),
                                   (65, 65), (127, 127), (129, 129),
                                   (127, 129), (1000, 1000), (200, 17)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_across_tile_edges(cuda, d, sq, sk, causal):
    _fwd_case(cuda, 2, sq, sk, d, causal, 30)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(200, 17), (1000, 129), (130, 1)])
def test_flash_kernel_causal_rows_that_see_no_key(cuda, d, sq, sk):
    """Causal with sq > sk (offset sk - sq < 0): the first sq - sk rows
    see no key and emit 0 and lse -1e30; the rest match the plain
    version."""
    out, lse = _fwd_case(cuda, 2, sq, sk, d, True, 34)
    dead = sq - sk
    assert bool((out[:, :dead] == 0).all())
    assert bool((lse[:, :dead] == -1e30).all())
    assert bool((lse[:, dead:] > -1e29).all())


@pytest.mark.parametrize("causal,valid", [(True, (150, 150)),
                                          (False, (100, 190)),
                                          (True, (129, 65)),
                                          (False, (1, 1))])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_validity_window_ends_mid_tile(cuda, causal, valid, d):
    """Windows ending inside a 128-query block and a key tile: rows past
    the window emit 0 and lse -1e30."""
    out, lse = _fwd_case(cuda, 2, 256, 256, d, causal, 38, causal_off=0,
                         valid=valid)
    assert bool((out[:, valid[0]:] == 0).all())
    assert bool((lse[:, valid[0]:] == -1e30).all())


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = _randn((1, 2, 16, 64), 7, cuda, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        attn.flash_attention(q, q, q, causal=True)
    qb = q.to(torch.bfloat16).requires_grad_()
    # a mask takes the masked forward; its backward is not ported
    before = _build.launch_counts()["flash_attention_masked"]
    out = attn.flash_attention(qb, qb, qb, mask=torch.zeros(
        1, 1, 16, 16, dtype=torch.bool, device=cuda))
    assert _build.launch_counts()["flash_attention_masked"] == before + 1
    with pytest.raises(NotImplementedError, match="mask operand"):
        out.float().sum().backward()
    qb = qb.detach()
    with pytest.raises(ValueError, match="mask must be"):
        attn.flash_attention(qb, qb, qb, mask=torch.zeros(
            16, 16, dtype=torch.bool, device=cuda))


# -- the masked forward (the mask3 operand) --------------------------------
#
# flash_attention(mask=...) against the masked kernel's plain version on
# the same mask3: per-batch [b, 1, sq, sk], one mask for all [1, 1, sq,
# sk], per head [b, h, sq, sk] and key-only [b, 1, 1, sk] (the decode
# and padding shapes), each with fully masked rows (0 out, lse -1e30),
# causal or not, lengths that cut the tiles; out and lse as above, and
# each query row's out within 2^-6 of its own max |ref| (as paged decode
# holds each slot: a row over thousands of keys reads ~0.02, so a
# dropped tile moves it by less than the absolute limit).

def _row_errors(got, ref):
    """Each query row's max |diff| over its own max |ref| (0/0 reads 0,
    an error on a fully masked row inf)."""
    d = ref.shape[-1]
    got, ref = got.float().reshape(-1, d), ref.float().reshape(-1, d)
    diff = (got - ref).abs().amax(1)
    mag = ref.abs().amax(1)
    return torch.where(diff == 0, torch.zeros_like(diff), diff / mag)


def _masked_case(cuda, b, h, sq, sk, d, mask_shape, causal, seed):
    q = _randn((b, h, sq, d), seed, cuda)
    k = _randn((b, h, sk, d), seed + 1, cuda)
    v = _randn((b, h, sk, d), seed + 2, cuda)
    mask = np.random.RandomState(seed + 3).rand(*mask_shape) > 0.5
    if mask_shape[2] > 1:
        mask[..., 0, :] = True              # every first row fully masked
    else:
        mask[-1] = True                     # every key of the last mask
    mask = torch.from_numpy(mask).to(cuda)
    counts = _build.launch_counts()
    out = attn.flash_attention(q, k, v, causal=causal, mask=mask)
    after = _build.launch_counts()
    assert after["flash_attention_masked"] == \
        counts["flash_attention_masked"] + 1
    assert after["flash_attention"] == counts["flash_attention"]
    mask3 = attn._mask3(mask, b, h, sq, sk)
    q3, k3, v3 = (t.reshape(b * h, -1, d) for t in (q, k, v))
    got, lse = attn._fwd(q3, k3, v3, causal, d ** -0.5, mask3=mask3)
    ref, ref_lse = attn._fwd_reference(q3, k3, v3, causal, d ** -0.5,
                                       mask3=mask3)
    torch.cuda.synchronize()
    assert (out.reshape(b * h, sq, d).float() - ref.float()).abs().max() \
        .item() <= 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    for g in (out, got):
        assert _row_errors(g, ref).max().item() <= 2.0 ** -6
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    dead = ref_lse <= -0.5e30
    assert bool((got[dead] == 0).all()) and bool((lse[dead] == -1e30).all())
    return dead


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("kind", ["per-batch", "one", "per-head",
                                  "key-only"])
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True),
                                          (130, 200, False),
                                          (1, 1000, False),
                                          (200, 130, True)])
def test_masked_flash_kernel_matches_plain(cuda, d, kind, sq, sk, causal):
    b, h = 2, 3
    shape = {"per-batch": (b, 1, sq, sk), "one": (1, 1, sq, sk),
             "per-head": (b, h, sq, sk), "key-only": (b, 1, 1, sk)}[kind]
    dead = _masked_case(cuda, b, h, sq, sk, d, shape, causal, 70)
    assert bool(dead.any())


@pytest.mark.parametrize("valid", [(90, 90), (129, 65), (1, 200)])
def test_masked_flash_kernel_validity_window(cuda, valid):
    """The mask with a ragged validity window and an explicit causal
    offset, through ``_fwd`` directly: rows past the window emit 0."""
    bh, s, d = 4, 256, 64
    q, k, v = (_randn((bh, s, d), seed, cuda) for seed in (80, 81, 82))
    mask3 = torch.from_numpy(
        np.random.RandomState(83).rand(2, s, s) > 0.7).to(cuda)
    for causal in (True, False):
        got, lse = attn._fwd(q, k, v, causal, 0.125, causal_off=0,
                             valid=valid, mask3=mask3)
        ref, ref_lse = attn._fwd_reference(q, k, v, causal, 0.125,
                                           causal_off=0, valid=valid,
                                           mask3=mask3)
        torch.cuda.synchronize()
        assert (got.float() - ref.float()).abs().max().item() <= 2e-2
        assert _row_errors(got, ref).max().item() <= 2.0 ** -6
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        assert bool((got[:, valid[0]:] == 0).all())


def test_unmasked_forward_launches_no_masked_kernel(cuda):
    q = _randn((1, 2, 130, 64), 84, cuda)
    counts = _build.launch_counts()
    attn.flash_attention(q, q, q, causal=True)
    after = _build.launch_counts()
    assert after["flash_attention"] == counts["flash_attention"] + 1
    assert after["flash_attention_masked"] == counts["flash_attention_masked"]


@pytest.mark.parametrize("group", [1, 4])
def test_decode_attention_kernel_branch_matches_its_plain_chain(cuda, group):
    """Dense-cache decode, sq = 1 against 3000 cached positions with
    lengths 0, 1, 1500 and 3000: the masked flash branch (k/v broadcast
    to the query heads) against the plain grouped chain, on the card."""
    b, kvh, s_cache, d = 4, 2, 3000, 128
    h = kvh * group
    q = _randn((b, h, d), 85, cuda)
    k = _randn((b, kvh, s_cache, d), 86, cuda)
    v = _randn((b, kvh, s_cache, d), 87, cuda)
    lengths = torch.tensor([0, 1, 1500, 3000], dtype=torch.int32,
                           device=cuda)
    before = _build.launch_counts()["flash_attention_masked"]
    got = attn.decode_attention(q, k, v, lengths, use_kernel=True)
    assert _build.launch_counts()["flash_attention_masked"] == before + 1
    ref = attn.decode_attention(q, k, v, lengths, use_kernel=False)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert bool((got[0] == 0).all())


def test_masked_decode_drops_no_tile_of_a_long_slot(cuda):
    """The per-row limit sees one 128-key tile of an 8192-key slot left
    out: the kernel branch holds it, a mask that also hides the tile
    does not."""
    b, kvh, group, s_cache, d = 4, 8, 4, 8192, 128
    h = kvh * group
    q = _randn((b, h, 1, d), 88, cuda)
    k = _randn((b, h, s_cache, d), 89, cuda)
    v = _randn((b, h, s_cache, d), 90, cuda)
    lengths = torch.tensor([8192, 4097, 100, 0], dtype=torch.int32,
                           device=cuda)
    mask = (torch.arange(s_cache, device=cuda)[None, None, None, :]
            >= lengths[:, None, None, None])
    got = attn.flash_attention(q, k, v, mask=mask)
    mask3 = attn._mask3(mask, b, h, 1, s_cache)
    q3, k3, v3 = (t.reshape(b * h, -1, d) for t in (q, k, v))
    ref = attn._fwd_reference(q3, k3, v3, False, d ** -0.5, mask3=mask3)[0]
    drop = mask3.clone()
    drop[0, :, 4096:4224] = True
    off = attn._fwd_reference(q3, k3, v3, False, d ** -0.5, mask3=drop)[0]
    torch.cuda.synchronize()
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert _row_errors(off, ref)[:h].min().item() > 2.0 ** -6


# -- the masked forward's tile classes ---------------------------------
#
# The pre-pass sorts each (mask, 128-query block, 128-key tile) into
# dead, full or partial; the kernel skips dead tiles, takes full ones
# whole and reads a partial one's bits.  Masks built so that every kind
# of tile occurs, over 3 query blocks (the last ragged) and 5 key tiles
# (the last ragged), two masks over four heads, causal or not.

def _tile_mask(kind, nmask, sq, sk, seed):
    rng = np.random.RandomState(seed)
    mask = rng.rand(nmask, sq, sk) < 0.05
    if kind == "dead-middle":           # key tile 1 dead for every row
        mask[:, :, 128:256] = True
    elif kind == "dead-block":          # query block 1 of mask 0 all dead
        mask[0, 128:256, :] = True
    elif kind == "all-full":            # nothing masked: every tile full
        mask[:] = False
    elif kind == "dead-some-rows":      # tile 2 dead for rows 0..63 only,
        mask[:, 0:64, 256:384] = True   # rows 128..191 fully masked
        mask[:, 128:192, :] = True
    return mask


@pytest.mark.parametrize("kind", ["dead-middle", "dead-block", "all-full",
                                  "dead-some-rows"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_masked_flash_kernel_tile_classes(cuda, kind, causal, d):
    bh, sq, sk, nmask = 4, 300, 520, 2
    q, k, v = (_randn((bh, s_, d), seed, cuda)
               for s_, seed in ((sq, 110), (sk, 111), (sk, 112)))
    mask3 = torch.from_numpy(_tile_mask(kind, nmask, sq, sk, 113)).to(cuda)
    before = _build.launch_counts()["flash_attention_masked"]
    got, lse = attn._fwd(q, k, v, causal, d ** -0.5, mask3=mask3)
    assert _build.launch_counts()["flash_attention_masked"] == before + 1
    ref, ref_lse = attn._fwd_reference(q, k, v, causal, d ** -0.5,
                                       mask3=mask3)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    dead = ref_lse <= -0.5e30
    assert bool((got[dead] == 0).all()) and bool((lse[dead] == -1e30).all())
    if kind == "dead-block":
        assert bool(dead[:2, 128:256].all())
    if kind == "all-full":
        plain, plain_lse = attn._fwd(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert (got.float() - plain.float()).abs().max().item() <= 2e-2
        assert (lse - plain_lse).abs().max().item() <= 1e-3


# -- decode against the dense cache without the k/v broadcast -----------
#
# decode_attention's kernel branch on one layer's strided view of a
# [slots, layers, kv_heads, S, d] cache: the query heads of a kv head as
# the rows of one problem, the lengths as the mask; lengths on and
# across the kernel's 64-position tiles and the flash tile's 128, and
# the whole 8192-position cache.  Held against the decode kernel's plain
# version per row (2^-6 of each row's own max) and absolutely.

DENSE_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 8192]


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_kernel_reads_the_strided_cache_without_broadcast(
        cuda, group, d):
    b, kvh, layers, s_cache = len(DENSE_LENGTHS), 2, 2, 8192
    ck = _randn((b, layers, kvh, s_cache, d), 120, cuda)
    cv = _randn((b, layers, kvh, s_cache, d), 121, cuda)
    q = _randn((b, kvh * group, 1, d), 122, cuda)
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=cuda)
    kv, vv = ck[:, 1], cv[:, 1]
    assert not kv.is_contiguous()
    counts = _build.launch_counts()
    got = attn.decode_attention(q, kv, vv, lengths, use_kernel=True)
    after = _build.launch_counts()
    assert after["flash_attention_masked"] == \
        counts["flash_attention_masked"] + 1
    assert after["flash_attention"] == counts["flash_attention"]
    ref = attn._decode_reference(q.reshape(b, kvh, group, d), kv, vv,
                                 lengths, d ** -0.5)
    torch.cuda.synchronize()
    got = got.reshape(b, kvh, group, d)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert bool((got[0] == 0).all())


def test_decode_kernel_drops_no_tile_of_a_long_slot(cuda):
    """The per-row limit sees one 64-position tile of an 8192-position
    slot left out; the kernel holds it."""
    b, kvh, group, s_cache, d = 2, 8, 4, 8192, 128
    k = _randn((b, kvh, s_cache, d), 123, cuda)
    v = _randn((b, kvh, s_cache, d), 124, cuda)
    q = _randn((b, kvh * group, d), 125, cuda)
    lengths = torch.tensor([8192, 5000], dtype=torch.int32, device=cuda)
    got = attn.decode_attention(q, k, v, lengths, use_kernel=True)
    qg = q.reshape(b, kvh, group, d)
    ref = attn._decode_reference(qg, k, v, lengths, d ** -0.5)
    hole = k.clone()
    hole[0, :, 4096:4160] = 0
    off = attn._decode_reference(qg, hole, v, lengths, d ** -0.5)
    torch.cuda.synchronize()
    got = got.reshape(b, kvh, group, d)
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert _row_errors(off[0], ref[0]).min().item() > 2.0 ** -6


def test_decode_branch_allocates_no_broadcast(cuda):
    """At Llama-3-8B's [8, 32, 1, 8192] over 8 kv heads the broadcast k/v
    alone would be 1.07 GB: the kernel branch's peak rises by less than
    64 MB over the call (its output and the split partials)."""
    b, h, kvh, s_cache, d = 8, 32, 8, 8192, 128
    k = _randn((b, kvh, s_cache, d), 126, cuda)
    v = _randn((b, kvh, s_cache, d), 127, cuda)
    q = _randn((b, h, 1, d), 128, cuda)
    lengths = torch.tensor([0, 1, 100, 1000, 4097, 6000, 8000, 8192],
                           dtype=torch.int32, device=cuda)
    attn.decode_attention(q, k, v, lengths, use_kernel=True)   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    start = torch.cuda.memory_allocated(cuda)
    out = attn.decode_attention(q, k, v, lengths, use_kernel=True)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(cuda) - start
    assert out.shape == (b, h, 1, d)
    assert rise < 64 * 2 ** 20, rise


@pytest.mark.parametrize("slots", [1, 8, 9])
def test_fused_gpt_block_kernel_slot_counts(cuda, slots):
    """The GPT instance at 1, 8 and 9 slots (one pass of eight, a full
    pass, a second pass of one) over lengths up to past the window."""
    lengths = [0, 1, 15, 16, 255, 256, 257, 384, 500][:slots]
    if slots == 1:
        lengths = [300]
    args, kw = _gpt_fused_case(cuda, 128, lengths)
    before = _build.launch_counts()["fused_block_decode_gpt"]
    got = pa.fused_block_decode(*args, **kw)
    assert _build.launch_counts()["fused_block_decode_gpt"] == before + 1
    ref = pa.fused_block_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d,ps", [(64, 16), (128, 64)])
def test_paged_kernel_matches_plain(cuda, group, d, ps):
    slots, kvh, layers, mpps = 6, 2, 3, 700 // ps + 1
    lengths_l = [0, 1, ps, ps + 1, 300, 700]
    n_pages = slots * mpps
    pool_k = _randn((n_pages + 1, layers, kvh, ps, d), 8, cuda)
    pool_v = _randn((n_pages + 1, layers, kvh, ps, d), 9, cuda)
    perm = np.random.RandomState(10).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(lengths_l):
        need = -(-n // ps)
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    table = torch.from_numpy(table).to(cuda)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=cuda)
    q = _randn((slots, kvh * group, d), 11, cuda)
    kp, vp = pool_k[:, 1], pool_v[:, 1]            # strided layer views
    got = pa.paged_decode_attention(q, kp, vp, table, lengths)
    ref = pa.paged_decode_reference(q, kp, vp, table, lengths, d ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert bool((got[0] == 0).all())


def _paged_case(cuda, lengths, group, d, ps, mpps, kvh=2, seed=30):
    """A pool holding only the live pages (and a trash page) for the
    given lengths, one layer of two read through a strided view; q."""
    slots = len(lengths)
    need = [min(-(-max(n, 0) // ps), mpps) for n in lengths]
    n_pages = sum(need)
    pool_k = _randn((n_pages + 1, 2, kvh, ps, d), seed, cuda)
    pool_v = _randn((n_pages + 1, 2, kvh, ps, d), seed + 1, cuda)
    perm = np.random.RandomState(seed + 2).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(need):
        table[s, :n] = perm[cursor:cursor + n]
        cursor += n
    table = torch.from_numpy(table).to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = _randn((slots, kvh * group, d), seed + 3, cuda)
    return q, pool_k[:, 1], pool_v[:, 1], table, lens


def _slot_errors(got, ref):
    """Each slot's max |diff| over its own max |ref|: a long slot's
    outputs average many tokens and are small, so one limit for all
    slots would let a dropped page of a long slot pass (0/0 reads 0, an
    error on an empty slot inf)."""
    diff = (got.float() - ref.float()).abs().flatten(1).amax(1)
    mag = ref.float().abs().flatten(1).amax(1)
    return torch.where(diff == 0, torch.zeros_like(diff), diff / mag)


def _assert_paged_kernel(case):
    """One launch a call, each slot within 2^-6 of its own magnitude of
    the plain version (one bf16 ulp of the output is 2^-8 of it, p is
    rounded in other places), zeros for an empty slot, the same bits from
    a second call."""
    q, kp, vp, table, lens = case
    before = _build.launch_counts()["paged_attention"]
    got = pa.paged_decode_attention(q, kp, vp, table, lens)
    assert _build.launch_counts()["paged_attention"] == before + 1
    again = pa.paged_decode_attention(q, kp, vp, table, lens)
    ref = pa.paged_decode_reference(q, kp, vp, table, lens,
                                    q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert _slot_errors(got, ref).max().item() <= 2.0 ** -6
    assert torch.equal(got, again)
    empty = (lens <= 0).nonzero().flatten()
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ps", [16, 32, 64, 128])
def test_paged_kernel_every_instance_across_page_and_split_edges(
        cuda, group, d, ps):
    """A 1024-position window over 10 slots and 2 kv heads: lengths on
    and across a page edge and the first split edge of the card's plan,
    the full window, past it."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = pa._plan_splits(10, 2, group, d, ps, 1024 // ps, sms)
    assert plan.nsplit > 1
    b = plan.pages_per_split * ps
    lengths = [0, 1, ps - 1, ps, ps + 1, b - 1, b, b + 1, 1024, 1100]
    _assert_paged_kernel(_paged_case(cuda, lengths, group, d, ps,
                                     1024 // ps))


def test_paged_kernel_all_slots_empty(cuda):
    q, kp, vp, table, lens = _paged_case(cuda, [0, 0, 0], 4, 128, 64, 16)
    got = pa.paged_decode_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert bool((got == 0).all())


@pytest.mark.parametrize("lengths", [
    [8192], [0, 100, 4095, 4096, 4097, 6000, 8192, 9000]])
def test_paged_kernel_8192_position_window(cuda, lengths):
    """Llama-3-8B's context: page 64, 128 pages a slot, 8 kv heads of
    group 4 (the split plan's card-filling branch at 8 slots)."""
    _assert_paged_kernel(_paged_case(cuda, lengths, 4, 128, 64, 128,
                                     kvh=8, seed=31))


def test_paged_kernel_drops_no_page_of_a_long_slot(cuda):
    """The per-slot limit sees one 64-token page of a 4096-token slot
    left out: the kernel holds it, a table that skips the page does
    not."""
    lengths = [4096, 1500, 64, 1]
    q, kp, vp, table, lens = _paged_case(cuda, lengths, 4, 128, 64, 64,
                                         kvh=8, seed=33)
    got = pa.paged_decode_attention(q, kp, vp, table, lens)
    ref = pa.paged_decode_reference(q, kp, vp, table, lens, 128 ** -0.5)
    dropped = table.clone()
    dropped[0, 20] = dropped[0, 21]
    off = pa.paged_decode_reference(q, kp, vp, dropped, lens, 128 ** -0.5)
    torch.cuda.synchronize()
    assert _slot_errors(got, ref).max().item() <= 2.0 ** -6
    assert _slot_errors(off, ref)[0].item() > 2.0 ** -6


def test_paged_kernel_streams_keep_their_own_merge_counters(cuda):
    """A call on a side stream and one on the default stream run several
    splits each with counters of their own; both hold the plain
    version."""
    case = _paged_case(cuda, [1024, 700, 0, 513], 4, 128, 64, 16, kvh=2,
                       seed=34)
    ref = pa.paged_decode_reference(*case, 128 ** -0.5)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got_side = pa.paged_decode_attention(*case)
    got = pa.paged_decode_attention(*case)
    torch.cuda.synchronize()
    keys = {k for k in pa._COUNTERS if k[0] == got.device}
    assert (got.device, side.cuda_stream) in keys and len(keys) >= 2
    for out in (got, got_side):
        assert _slot_errors(out, ref).max().item() <= 2.0 ** -6
    assert torch.equal(got, got_side)


def test_paged_kernel_failed_launch_leaves_counters_zero(cuda, monkeypatch):
    """A launch that fails leaves no count behind: the wrapper zeroes the
    stream's counters, so the next call merges right."""
    case = _paged_case(cuda, [1024, 700, 0, 513], 4, 128, 64, 16, kvh=2,
                       seed=35)
    ref = pa.paged_decode_reference(*case, 128 ** -0.5)
    pa.paged_decode_attention(*case)
    dev = case[0].device
    counters = pa._counters(dev, _build.stream_ptr(dev), 1)
    counters.fill_(3)     # what an aborted launch could leave

    class Failing:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        @staticmethod
        def apex_paged_decode_attention(*args):
            return 1      # cudaErrorInvalidValue

    real = _build.library()
    monkeypatch.setattr(_build, "library", lambda: Failing(real))
    with pytest.raises(RuntimeError, match="paged_attention"):
        pa.paged_decode_attention(*case)
    monkeypatch.undo()
    assert int(counters.abs().sum().item()) == 0
    got = pa.paged_decode_attention(*case)
    torch.cuda.synchronize()
    assert _slot_errors(got, ref).max().item() <= 2.0 ** -6


def test_cuda_engine_refuses_a_page_size_without_a_kernel_when_built(cuda):
    """An unfused engine on the card checks its page size when it is
    built, not at its first decode step."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(vocab_size=256, hidden_size=128, num_layers=1,
                      num_attention_heads=4, num_kv_heads=2,
                      ffn_hidden_size=256, max_seq_length=256)
    for ps in (8, 256):
        with pytest.raises(ValueError, match="page_size"):
            InferenceEngine("llama", cfg, None, slots=2, max_seq=256,
                            page_size=ps, device=cuda, decode_fusion="0")


@pytest.mark.parametrize("slots", [1, 64, 256])
def test_paged_kernel_slot_counts(cuda, slots):
    """1 and 64 slots run several splits of a 1024-position window, 256
    fill the card with one split each (the kernel writes its output
    with no merge)."""
    rng = np.random.RandomState(slots)
    lengths = [int(n) for n in rng.randint(0, 1100, size=slots)]
    lengths[0] = 1024
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = pa._plan_splits(slots, 2, 4, 64, 16, 64, sms)
    assert (plan.nsplit == 1) == (slots * 2 >= pa._BLOCKS_PER_SM * sms)
    _assert_paged_kernel(_paged_case(cuda, lengths, 4, 64, 16, 64, seed=32))


@pytest.mark.parametrize("hidden", [4096, 1001, 64])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
def test_norm_kernels_match_plain(cuda, hidden, x_dtype, w_dtype):
    x = _randn((37, hidden), 12, cuda, x_dtype) * 3 + 0.5
    w = 1 + 0.1 * _randn((hidden,), 13, cuda, w_dtype)
    b = 0.1 * _randn((hidden,), 14, cuda, w_dtype)
    for got, ref in ((ln.rms_norm(x, w), ln.rms_norm_reference(x, w)),
                     (ln.layer_norm(x, w, b),
                      ln.layer_norm_reference(x, w, b))):
        assert got.dtype == x_dtype
        tol = 2.0 ** -6 * ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol


# -- the training slice's kernels ----------------------------------------
#
# Tolerances: norm dx within 2^-6 of its magnitude (bf16 ulps), dw within
# 1e-3 of its magnitude (fp32 sums over rows in another order, of
# products of rounded inputs); flash dq/dk/dv within a relative L2 of
# 1e-2 of the plain version (fp32 accumulation in another order, dq summed
# in any order), and either element by element within 2^-6 |ref| + 2^-9
# (two bf16 ulps of each element and a floor far below a typical one) or,
# against the exact float64 gradient (p and ds unrounded), within 5%
# (relative L2) and 25% (max |err|) of the plain version's own error.
# Both sides round p and ds to bf16 at the same points from fp32 values
# that differ in their last bits: where a p in [0.5, 1) rounds to the
# other side (short key rows, 17 keys) one element moves past the element
# rule's floor, and where an output has a handful of elements (one query
# row) one rounding moves its error ratio past 5%; the earlier mma.sync
# version of the kernel reads alike on every case, and a wrong backward
# misses both by orders of magnitude; through autograd against the fp32
# math of the whole attention (p not rounded), a relative L2 of 1e-2 per
# grad; the unscale exact (one fp32 multiply, the same on both sides);
# Adam within 1e-6 relative (the kernel may contract multiply-adds into
# FMAs), and bit-identical under the noop flag.


def _maxdiff(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _exact_grads(q, k, v, do, causal, scale, causal_off=None, valid=None):
    """(dq, dk, dv) in float64 from the bf16 operands, p and ds unrounded,
    with the kernels' causal offset and validity window; fully masked
    rows give 0."""
    sq, sk = q.shape[1], k.shape[1]
    off = (sk - sq) if causal_off is None else causal_off
    q_, k_, v_, do_ = (t.double() for t in (q, k, v, do))
    live = attn._live_mask(sq, sk, causal, off, valid, q.device)
    s = (torch.matmul(q_, k_.transpose(1, 2)) * scale).masked_fill(
        ~live, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    delta = (do_ * torch.matmul(p, v_)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do_, v_.transpose(1, 2)) - delta)
    return (scale * torch.matmul(ds, k_),
            scale * torch.matmul(ds.transpose(1, 2), q_),
            torch.matmul(p.transpose(1, 2), do_))


def _assert_flash_bwd_close(got, ref, exact):
    for g, r, x in zip(got, ref, exact):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, r) <= 1e-2
        g32, r32 = g.float(), r.float()
        by_element = bool(((g32 - r32).abs()
                           <= 2.0 ** -6 * r32.abs() + 2.0 ** -9).all())
        ge, re = g.double() - x, r.double() - x
        by_exact = bool(ge.norm() <= 1.05 * re.norm()) and bool(
            ge.abs().max() <= 1.25 * re.abs().max())
        assert by_element or by_exact


@pytest.mark.parametrize("hidden", [4096, 1001, 64])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("rms", [True, False])
def test_norm_bwd_kernel_matches_plain(cuda, hidden, x_dtype, w_dtype, rms):
    x = _randn((300, hidden), 20, cuda, x_dtype) * 2 + 0.3
    w = 1 + 0.1 * _randn((hidden,), 21, cuda, w_dtype)
    dy = _randn((300, hidden), 22, cuda, x_dtype)
    before = _build.launch_counts()["layer_norm_bwd"]
    dx, dw, db = ln._bwd_2d(x, w, dy, 1e-5, rms)
    assert _build.launch_counts()["layer_norm_bwd"] == before + 1
    rdx, rdw, rdb = ln._bwd_reference(x, w, dy, 1e-5, rms)
    torch.cuda.synchronize()
    assert dx.dtype == x_dtype and dw.dtype == torch.float32
    assert _maxdiff(dx, rdx) <= 2.0 ** -6 * rdx.float().abs().max().item()
    assert _maxdiff(dw, rdw) <= 1e-3 * rdw.abs().max().item()
    if rms:
        assert db is None
    else:
        assert _maxdiff(db, rdb) <= 1e-3 * rdb.abs().max().item()


@pytest.mark.parametrize("hidden", [64, 1001, 4096, 8192, 8200, 16384])
@pytest.mark.parametrize("rows", [1, 7, 2048])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("rms", [True, False])
def test_norm_bwd_kernel_instances_match_plain_and_repeat(
        cuda, hidden, rows, x_dtype, w_dtype, rms):
    """Each instance the plan picks: rows in warps (64), in blocks (1001
    one element at a time, 4096, 8192), in passes (8200, 16384); one
    row, a few, a training step's; dw and db the same bits twice."""
    x = _randn((rows, hidden), 25, cuda, x_dtype) * 2 + 0.3
    w = 1 + 0.1 * _randn((hidden,), 26, cuda, w_dtype)
    dy = _randn((rows, hidden), 27, cuda, x_dtype)
    before = _build.launch_counts()["layer_norm_bwd"]
    dx, dw, db = ln._bwd_2d(x, w, dy, 1e-5, rms)
    assert _build.launch_counts()["layer_norm_bwd"] == before + 1
    dx2, dw2, db2 = ln._bwd_2d(x, w, dy, 1e-5, rms)
    rdx, rdw, rdb = ln._bwd_reference(x, w, dy, 1e-5, rms)
    torch.cuda.synchronize()
    assert dx.dtype == x_dtype and dw.dtype == torch.float32
    assert _maxdiff(dx, rdx) <= 2.0 ** -6 * rdx.float().abs().max().item()
    assert _maxdiff(dw, rdw) <= 1e-3 * rdw.abs().max().item()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    if rms:
        assert db is None
    else:
        assert _maxdiff(db, rdb) <= 1e-3 * rdb.abs().max().item()
        assert torch.equal(db, db2)


def test_norm_autograd_launches_the_backward_kernel(cuda):
    x = _randn((64, 256), 23, cuda).requires_grad_()
    w = (1 + 0.1 * _randn((256,), 24, cuda)).requires_grad_()
    before = _build.launch_counts()["layer_norm_bwd"]
    ln.rms_norm(x, w).float().square().sum().backward()
    assert _build.launch_counts()["layer_norm_bwd"] == before + 1
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(100, 100), (40, 200), (130, 64),
                                   (256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_plain(cuda, d, sq, sk, causal):
    q, k, v = (_randn((3, s, d), seed, cuda)
               for seed, s in ((30, sq), (31, sk), (32, sk)))
    do = _randn((3, sq, d), 33, cuda)
    scale = d ** -0.5
    out, lse = attn._fwd(q, k, v, causal, scale)
    before = _build.launch_counts()["flash_attention_bwd"]
    got = attn._bwd(q, k, v, out, lse, do, causal, scale)
    assert _build.launch_counts()["flash_attention_bwd"] == before + 1
    ref = attn._bwd_reference(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    _assert_flash_bwd_close(got, ref, _exact_grads(q, k, v, do, causal,
                                                   scale))


def test_flash_bwd_kernel_validity_window_and_offset(cuda):
    q, k, v, do = (_randn((2, 128, 64), seed, cuda) for seed in (34, 35, 36,
                                                                37))
    out, lse = attn._fwd(q, k, v, True, 0.125, causal_off=0, valid=(90, 90))
    got = attn._bwd(q, k, v, out, lse, do, True, 0.125, causal_off=0,
                    valid=(90, 90))
    ref = attn._bwd_reference(q, k, v, out, lse, do, True, 0.125,
                              causal_off=0, valid=(90, 90))
    _assert_flash_bwd_close(got, ref, _exact_grads(q, k, v, do, True, 0.125,
                                                   0, (90, 90)))
    assert bool((got[0][:, 90:] == 0).all()) and bool((got[1][:, 90:] == 0)
                                                      .all())


def _gqa_autograd(cuda, h, kvh, s, d, seed):
    """k/v broadcast to the q heads before the kernel, as the model does:
    autograd sums dk/dv over each group."""
    g = h // kvh
    q = _randn((1, h, s, d), seed, cuda).requires_grad_()
    kk = _randn((1, kvh, s, d), seed + 1, cuda).requires_grad_()
    vv = _randn((1, kvh, s, d), seed + 2, cuda).requires_grad_()
    k, v = (t[:, :, None].expand(1, kvh, g, s, d).reshape(1, h, s, d)
            for t in (kk, vv))
    do = _randn((1, h, s, d), seed + 3, cuda)
    attn.flash_attention(q, k, v, causal=True).backward(do)
    q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, kk, vv))
    kf, vf = (t[:, :, None].expand(1, kvh, g, s, d).reshape(1, h, s, d)
              for t in (k2, v2))
    attn.mha_reference(q2, kf, vf, causal=True).backward(do.float())
    for g_, r in ((q.grad, q2.grad), (kk.grad, k2.grad), (vv.grad, v2.grad)):
        assert _rel_l2(g_, r) <= 1e-2


def test_flash_autograd_sums_gqa_groups(cuda):
    _gqa_autograd(cuda, 4, 2, 96, 64, 38)


def test_flash_autograd_sums_gqa_groups_across_tiles(cuda):
    """The model's head dim and query groups (4 heads a kv head) at a
    length that ends inside a key tile and a query step."""
    _gqa_autograd(cuda, 8, 2, 200, 128, 42)


@pytest.mark.parametrize("n", [1 << 20, 1000003])
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
def test_fused_scale_kernel_matches_plain(cuda, n, src_dtype):
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    x = _randn((n,), 42, cuda, src_dtype) * 1000
    scale = torch.full((), 2.0 ** -16, device=cuda)
    before = _build.launch_counts()["fused_scale"]
    out, flag = fu.fused_scale(x, scale, torch.float32)
    assert _build.launch_counts()["fused_scale"] == before + 1
    ref, rflag = fu._scale_reference(x, scale, torch.float32)
    assert torch.equal(out, ref) and flag.item() == 0.0 == rflag.item()
    x[n // 3] = float("inf")
    _, flag = fu.fused_scale(x, scale, torch.float32)
    assert flag.item() == 1.0
    # in place, on an offset view (the scalar path of the kernel)
    y = _randn((n + 1,), 43, cuda)[1:]
    want = y * 0.5
    y[7] = float("nan")
    want[7] = float("nan")
    got, flag = fu.fused_scale(y, 0.5, out=y)
    assert got.data_ptr() == y.data_ptr() and flag.item() == 1.0
    assert torch.equal(torch.nan_to_num(got, 9.0), torch.nan_to_num(want,
                                                                     9.0))


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_fused_adam_kernel_matches_plain(cuda, adam_w, g_dtype):
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    n = 1000003
    p, m = _randn((n,), 44, cuda, torch.float32), _randn((n,), 45, cuda,
                                                         torch.float32)
    v = _randn((n,), 46, cuda, torch.float32).abs()
    g = _randn((n,), 47, cuda, g_dtype)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              step=torch.full((), 3.0, device=cuda), adam_w_mode=adam_w,
              grad_scale=0.5)
    hp = fu._adam_hparams(cuda, noop_flag=0.0, bias_correction=True,
                          **{k: kw[k] for k in ("lr", "beta1", "beta2", "eps",
                                                "weight_decay", "step",
                                                "grad_scale")})
    ref = fu._adam_kernel_reference(p, g, m, v, hp, adam_w)
    before = _build.launch_counts()["fused_adam"]
    got = fu.fused_adam_flat(p, g, m, v, **kw)
    assert _build.launch_counts()["fused_adam"] == before + 1
    assert got[0].data_ptr() == p.data_ptr()
    for a, b in zip(got, ref):
        assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()
    snap = [t.clone() for t in (p, m, v)]
    fu.fused_adam_flat(p, g, m, v, noop_flag=torch.ones((), device=cuda),
                       **kw)
    assert all(torch.equal(a, b) for a, b in zip((p, m, v), snap))


# -- the optimizer family: L2 norm, LAMB phase 1, SGD, Adagrad ------------
#
# Each at an odd length and on views that start one element in (LAMB's
# per-leaf slices start anywhere: the kernels' scalar path), with fp32
# and bf16 grads; the update kernels against their plain versions within
# 1e-6 of the output's magnitude (one fp32 multiply-add contracted or
# not), and a noop step bit for bit.

def _fu():
    return importlib.import_module("apex_tpu_torch.ops.fused_update")


def _flat(n, seed, dev, offset, dtype=torch.float32):
    """n elements starting ``offset`` elements into their allocation."""
    return _randn((n + offset,), seed, dev, dtype)[offset:]


@pytest.mark.parametrize("n", [5, 1000003, 1 << 22])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_l2norm_kernel_matches_plain_and_repeats(cuda, n, dtype,
                                                       offset):
    fu = _fu()
    x = _flat(n, 48, cuda, offset, dtype) * 3
    before = _build.launch_counts()["fused_l2norm"]
    got = fu.fused_l2norm(x)
    assert _build.launch_counts()["fused_l2norm"] == before + 1
    ref = fu._l2norm_reference(x)
    # fp32 sums of squares in another order
    assert abs(got.item() - ref.item()) <= 1e-5 * ref.item()
    # a fixed summation order: the same bits every run
    for _ in range(3):
        assert torch.equal(fu.fused_l2norm(x), got)
    norms = torch.zeros(4, device=cuda)
    fu.fused_l2norm(x, out=norms[2])
    assert norms[2].item() == got.item() and norms[3].item() == 0.0
    assert fu.fused_l2norm(x[:0]).item() == 0.0


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_lamb1_kernel_matches_plain(cuda, g_dtype, offset):
    fu = _fu()
    n = 1000003
    p = _flat(n, 49, cuda, offset)
    m = _flat(n, 50, cuda, offset) * 0.1
    v = _flat(n, 51, cuda, offset).abs()
    g = _flat(n, 52, cuda, offset, g_dtype)
    u = torch.empty(n + offset, device=cuda)[offset:]
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              step=torch.full((), 3.0, device=cuda), bias_correction=True,
              grad_scale=0.5, grad_averaging=True)
    hp = fu._lamb1_hparams(cuda, noop_flag=0.0, **kw)
    ref = fu._lamb1_kernel_reference(p, g, m, v, hp)
    before = _build.launch_counts()["fused_lamb1"]
    got = fu.fused_lamb_phase1_flat(p, g, m, v, u=u, **kw)
    assert _build.launch_counts()["fused_lamb1"] == before + 1
    assert got[2].data_ptr() == u.data_ptr()
    for a, b in zip(got, ref):
        assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()
    snap = [t.clone() for t in (m, v)]
    fu.fused_lamb_phase1_flat(p, g, m, v, u=u,
                              noop_flag=torch.ones((), device=cuda), **kw)
    assert torch.equal(m, snap[0]) and torch.equal(v, snap[1])
    assert torch.equal(u, torch.zeros_like(u))


@pytest.mark.parametrize("nesterov,wd_after,first,momentum", [
    (False, False, False, 0.9), (True, True, False, 0.9),
    (True, False, True, 0.9), (False, False, False, 0.0)])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_sgd_kernel_matches_plain(cuda, nesterov, wd_after, first,
                                        momentum, g_dtype, offset):
    fu = _fu()
    n = 1000003
    p, b = _flat(n, 53, cuda, offset), _flat(n, 54, cuda, offset)
    g = _flat(n, 55, cuda, offset, g_dtype)
    kw = dict(lr=0.1, momentum=momentum, dampening=0.1, weight_decay=0.01,
              first_run=torch.full((), float(first), device=cuda),
              grad_scale=0.5)
    hp = fu._sgd_hparams(cuda, noop_flag=0.0, **kw)
    ref = fu._sgd_kernel_reference(p, g, b, hp, nesterov, wd_after)
    before = _build.launch_counts()["fused_sgd"]
    got = fu.fused_sgd_flat(p, g, b, nesterov=nesterov,
                            wd_after_momentum=wd_after, **kw)
    assert _build.launch_counts()["fused_sgd"] == before + 1
    assert got[0].data_ptr() == p.data_ptr()
    for a, r in zip(got, ref):
        assert _maxdiff(a, r) <= 1e-6 * r.abs().max().item()
    snap = [t.clone() for t in (p, b)]
    fu.fused_sgd_flat(p, g, b, nesterov=nesterov, wd_after_momentum=wd_after,
                      noop_flag=torch.ones((), device=cuda), **kw)
    assert torch.equal(p, snap[0]) and torch.equal(b, snap[1])


@pytest.mark.parametrize("w_mode", [False, True])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_adagrad_kernel_matches_plain(cuda, w_mode, g_dtype, offset):
    fu = _fu()
    n = 1000003
    p = _flat(n, 56, cuda, offset)
    h = _flat(n, 57, cuda, offset).abs()
    g = _flat(n, 58, cuda, offset, g_dtype)
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.01, grad_scale=0.5)
    hp = fu._adagrad_hparams(cuda, noop_flag=0.0, **kw)
    ref = fu._adagrad_kernel_reference(p, g, h, hp, w_mode)
    before = _build.launch_counts()["fused_adagrad"]
    got = fu.fused_adagrad_flat(p, g, h, w_mode=w_mode, **kw)
    assert _build.launch_counts()["fused_adagrad"] == before + 1
    assert got[1].data_ptr() == h.data_ptr()
    for a, r in zip(got, ref):
        assert _maxdiff(a, r) <= 1e-6 * r.abs().max().item()
    snap = [t.clone() for t in (p, h)]
    fu.fused_adagrad_flat(p, g, h, w_mode=w_mode,
                          noop_flag=torch.ones((), device=cuda), **kw)
    assert torch.equal(p, snap[0]) and torch.equal(h, snap[1])


def test_lamb_rule_on_the_card_matches_its_plain_route(cuda):
    """One LAMB update of a 3-leaf flat state through the kernels (one
    global norm, a weight and a direction norm per leaf, one phase-1
    launch) against the same update with each kernel swapped for its
    plain version."""
    from apex_tpu_torch.optimizers import functional
    fu = _fu()
    sizes = {"a": 1001, "b": 4096, "c": 7}
    tree = {k: _randn((n,), 59 + i, cuda, torch.float32)
            for i, (k, n) in enumerate(sizes.items())}
    tx = functional.fused_lamb(lr=1e-2, weight_decay=0.01)
    g = _randn((sum(sizes.values()),), 63, cuda, torch.bfloat16)
    states = [tx.init(tree) for _ in range(2)]
    _build.reset_launch_counts()
    states[0] = tx.update(states[0], g)
    counts = _build.launch_counts()
    assert counts["fused_l2norm"] == 1 + 2 * len(sizes)
    assert counts["fused_lamb1"] == 1
    saved = (fu._l2norm_kernel, fu._lamb1_kernel)
    fu._l2norm_kernel, fu._lamb1_kernel = fu._l2norm_plain, fu._lamb1_plain
    try:
        states[1] = tx.update(states[1], g)
    finally:
        fu._l2norm_kernel, fu._lamb1_kernel = saved
    assert _build.launch_counts() == counts
    for a, b in ((states[0].master, states[1].master),
                 (states[0].slots["exp_avg"], states[1].slots["exp_avg"]),
                 (states[0].slots["exp_avg_sq"],
                  states[1].slots["exp_avg_sq"])):
        assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()


# -- the multi_tensor_apply kernels: axpby and the fused scale and norm --
#
# Both outputs exactly as their plain versions (axpby rounds each product
# before the sum, as the plain version's separate multiplies do; the
# fused scale is one fp32 multiply), the norm within 1e-5 of its plain
# fp32 sum (another order) and the same bits every run; odd lengths,
# views one element in (the scalar path), every dtype mix.

_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("n", [5, 1000003, 1 << 22])
@pytest.mark.parametrize("x_dtype,y_dtype,out_dtype", [
    (_F32, _F32, _F32), (_BF16, _BF16, _BF16), (_F32, _BF16, _F32),
    (_BF16, _F32, _BF16)])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_axpby_kernel_matches_plain(cuda, n, x_dtype, y_dtype,
                                          out_dtype, offset):
    fu = _fu()
    x = _flat(n, 64, cuda, offset, x_dtype)
    y = _flat(n, 65, cuda, offset, y_dtype)
    a, b = 0.75, torch.full((), -1.5, device=cuda)
    before = _build.launch_counts()["fused_axpby"]
    out, flag = fu.fused_axpby(a, x, b, y, out_dtype)
    assert _build.launch_counts()["fused_axpby"] == before + 1
    ab = torch.stack([fu._scalar(a, cuda), fu._scalar(b, cuda)])
    ref, rflag = fu._axpby_reference(x, y, ab, out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, ref)
    assert flag.item() == 0.0 == rflag.item()
    y[n // 2] = float("nan")
    assert fu.fused_axpby(a, x, b, y, out_dtype)[1].item() == 1.0
    empty, flag = fu.fused_axpby(a, x[:0], b, y[:0], out_dtype)
    assert empty.shape == (0,) and flag.item() == 0.0
    assert _build.launch_counts()["fused_axpby"] == before + 2


@pytest.mark.parametrize("n", [5, 1000003, 1 << 22])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (_F32, _F32), (_BF16, _BF16), (_F32, _BF16), (_BF16, _F32)])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_l2norm_scale_kernel_matches_plain_and_repeats(
        cuda, n, x_dtype, out_dtype, offset):
    fu = _fu()
    x = _flat(n, 66, cuda, offset, x_dtype).mul_(300)
    scale = torch.full((), 2.0 ** -8, device=cuda)
    before = _build.launch_counts()["fused_l2norm_scale"]
    out, norm, flag = fu.fused_l2norm_scale(x, scale, out_dtype)
    assert _build.launch_counts()["fused_l2norm_scale"] == before + 1
    ref, sumsq, rflag = fu._l2norm_scale_reference(x, scale, out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, ref)
    want = torch.sqrt(sumsq).item()
    assert abs(norm.item() - want) <= 1e-5 * want
    assert flag.item() == 0.0 == rflag.item()
    for _ in range(3):
        assert torch.equal(fu.fused_l2norm_scale(x, scale, out_dtype)[1], norm)
    x[n // 2] = float("inf")
    assert fu.fused_l2norm_scale(x, scale, out_dtype)[2].item() == 1.0
    before = _build.launch_counts()["fused_l2norm_scale"]
    empty, norm, flag = fu.fused_l2norm_scale(x[:0], scale, out_dtype)
    assert empty.shape == (0,) and norm.item() == 0.0 == flag.item()
    assert _build.launch_counts()["fused_l2norm_scale"] == before


def test_multi_tensor_applier_runs_the_kernels_on_the_card(cuda):
    """The shim over a mixed bf16/fp32 list on the card: one launch a
    call, outputs as the same calls on CPU copies."""
    from apex_tpu_torch.multi_tensor_apply import (
        multi_tensor_applier, multi_tensor_axpby, multi_tensor_l2norm,
        multi_tensor_l2norm_scale, multi_tensor_scale)
    xs = [_randn((37, 5), 67, cuda), _randn((1000,), 68, cuda, _F32),
          _randn((3, 4, 5), 69, cuda)]
    ys = [_randn(t.shape, 70 + i, cuda, t.dtype) for i, t in enumerate(xs)]
    calls = ((multi_tensor_scale, [xs], (0.5,)),
             (multi_tensor_axpby, [xs, ys], (2.0, -0.5)),
             (multi_tensor_l2norm, [xs], (True,)),
             (multi_tensor_l2norm_scale, [xs], (0.5, True)))
    _build.reset_launch_counts()
    got = [multi_tensor_applier(op, 0.0, lists, *args)
           for op, lists, args in calls]
    counts = _build.launch_counts()
    for name in ("fused_scale", "fused_axpby", "fused_l2norm",
                 "fused_l2norm_scale"):
        assert counts[name] == 1, counts
    cpu = [multi_tensor_applier(op, 0.0, [[t.cpu() for t in lst]
                                          for lst in lists], *args)
           for op, lists, args in calls]
    for g, r in zip(got, cpu):
        for a, b in zip(_leaves(g), _leaves(r)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _maxdiff(a.cpu(), b) <= 1e-6 * max(
                1.0, b.float().abs().max().item())


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _leaves(item)]
    return []


# -- the split flash backward: the dq kernel and the dk/dv kernel ---------
#
# Each against its plain version with the one-pass kernel's rule (two
# bf16 ulps of each element and an absolute floor, relative L2 1e-2 per
# output), and bit for bit from run to run (no atomics).

def _split_case(cuda, bh, sq, sk, d, causal, seed, causal_off=None,
                valid=None):
    q, k, v = (_randn((bh, s, d), seed + i, cuda)
               for i, s in enumerate((sq, sk, sk)))
    do = _randn((bh, sq, d), seed + 3, cuda)
    scale = d ** -0.5
    out, lse = attn._fwd(q, k, v, causal, scale, causal_off=causal_off,
                         valid=valid)
    return (q, k, v, lse, attn._delta(out, do), do, causal, scale,
            causal_off, valid), out


def _exact_of(args):
    """:func:`_exact_grads` of a :func:`_split_case`'s operands."""
    q, k, v, _, _, do, causal, scale, off, valid = args
    return _exact_grads(q, k, v, do, causal, scale, off, valid)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(100, 100), (40, 200), (130, 64),
                                   (256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_split_kernels_match_plain_and_repeat(cuda, d, sq, sk,
                                                        causal):
    args, _ = _split_case(cuda, 3, sq, sk, d, causal, 71)
    before = _build.launch_counts()
    dq = attn._dq_kernel(*args)
    dk, dv = attn._dkv_kernel(*args)
    after = _build.launch_counts()
    assert after["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    ref = (attn._dq_reference(*args), *attn._dkv_reference(*args))
    torch.cuda.synchronize()
    _assert_flash_bwd_close((dq, dk, dv), ref, _exact_of(args))
    assert torch.equal(attn._dq_kernel(*args), dq)
    dk2, dv2 = attn._dkv_kernel(*args)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.parametrize("causal,valid", [(True, (90, 90)),
                                          (False, (90, 70))])
def test_flash_bwd_split_validity_window_and_offset(cuda, causal, valid):
    """A padded bucket (explicit causal offset 0): padded rows get zero
    dq, padded keys zero dk and dv."""
    args, _ = _split_case(cuda, 2, 128, 128, 64, causal, 75, causal_off=0,
                          valid=valid)
    got = (attn._dq_kernel(*args), *attn._dkv_kernel(*args))
    ref = (attn._dq_reference(*args), *attn._dkv_reference(*args))
    _assert_flash_bwd_close(got, ref, _exact_of(args))
    assert bool((got[0][:, valid[0]:] == 0).all())
    assert bool((got[1][:, valid[1]:] == 0).all())
    assert bool((got[2][:, valid[1]:] == 0).all())


def test_flash_bwd_takes_the_jax_route_and_the_split_repeats(
        cuda, monkeypatch):
    """``_bwd`` runs the split pair exactly when sq * d * 4 passes the
    gate (at the real 2 MiB: 4096 rows of d 128 one-pass, 4097 split),
    the split route repeats bit for bit, and it agrees with the one-pass
    kernel forced onto the same inputs."""
    names = ("flash_attention_bwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")

    def routed(*a):
        before = _build.launch_counts()
        got = attn._bwd(*a)
        after = _build.launch_counts()
        return got, tuple(after[k] - before[k] for k in names)

    for s, want in ((4096, (1, 0, 0)), (4097, (0, 1, 1))):
        args, out = _split_case(cuda, 1, s, s, 128, True, 76)
        q, k, v, lse, _, do = args[:6]
        assert routed(q, k, v, out, lse, do, True, 128 ** -0.5)[1] == want
    args, out = _split_case(cuda, 4, 256, 256, 64, True, 80)
    q, k, v, lse, _, do = args[:6]
    bwd = (q, k, v, out, lse, do, True, 0.125)
    monkeypatch.setattr(attn, "_FUSED_BWD_MAX_BYTES", 256 * 64 * 4 - 1)
    split, counts = routed(*bwd)
    assert counts == (0, 1, 1)
    again, _ = routed(*bwd)
    assert all(torch.equal(a, b) for a, b in zip(split, again))
    monkeypatch.setattr(attn, "_FUSED_BWD_MAX_BYTES", 256 * 64 * 4)
    one, counts = routed(*bwd)
    assert counts == (1, 0, 0)
    _assert_flash_bwd_close(split, one, _exact_of(args))
    # dk and dv are the one-pass kernel's products with its dq half
    # compiled out: the same bits
    assert torch.equal(split[1], one[1]) and torch.equal(split[2], one[2])


# -- the one-pass kernel and the split dk/dv kernel across their tiles ---
#
# Lengths that cut the blocks' 128-key tiles and 64-query steps (1, 63,
# 65, 127, 129, 1000, and sk shorter than one key tile, down to one
# key), and validity
# windows that end inside a tile: each output against its plain version
# with the rule above; the split dk/dv kernel gives the one-pass
# kernel's dk and dv bit for bit (one template with its dq half compiled
# out) and repeats bit for bit.

def _one_pass_and_split(args, out):
    q, k, v, lse, _, do, causal, scale, off, valid = args
    before = _build.launch_counts()["flash_attention_bwd"]
    one = attn._bwd_kernel(q, k, v, out, lse, do, causal, scale, off, valid)
    assert _build.launch_counts()["flash_attention_bwd"] == before + 1
    ref = (attn._dq_reference(*args), *attn._dkv_reference(*args))
    torch.cuda.synchronize()
    _assert_flash_bwd_close(one, ref, _exact_of(args))
    dk, dv = attn._dkv_kernel(*args)
    assert torch.equal(dk, one[1]) and torch.equal(dv, one[2])
    dk2, dv2 = attn._dkv_kernel(*args)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    return one


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(1, 1000), (1000, 2), (63, 65), (65, 63),
                                   (127, 129), (129, 127), (1000, 1000),
                                   (200, 17)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_across_tile_edges(cuda, d, sq, sk, causal):
    _one_pass_and_split(*_split_case(cuda, 2, sq, sk, d, causal, 90))


@pytest.mark.parametrize("causal,valid", [(True, (150, 150)),
                                          (False, (100, 190))])
def test_flash_bwd_validity_window_ends_mid_tile(cuda, causal, valid):
    """Windows ending inside the second 128-key tile and inside a
    64-query step: rows past the window get zero dq, keys past it zero
    dk and dv."""
    one = _one_pass_and_split(*_split_case(cuda, 2, 256, 256, 128, causal,
                                           94, causal_off=0, valid=valid))
    assert bool((one[0][:, valid[0]:] == 0).all())
    assert bool((one[1][:, valid[1]:] == 0).all())
    assert bool((one[2][:, valid[1]:] == 0).all())


# -- the split dq kernel across its tiles --------------------------------
#
# The same lengths for the query-major dq kernel (128-query blocks,
# 64-key steps): against its plain version with the rule above, bit for
# bit from run to run (each block writes its queries' dq once), and
# within the flash backward's relative L2 (1e-2) of the one-pass
# kernel's dq, whose adds run in another order.

@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(1, 2), (2, 2), (1, 1000), (1000, 2),
                                   (63, 65), (65, 63), (127, 129),
                                   (129, 127), (1000, 1000), (200, 17)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_dq_kernel_across_tile_edges(cuda, d, sq, sk, causal):
    args, out = _split_case(cuda, 2, sq, sk, d, causal, 98)
    q, k, v, lse, _, do, _, scale, _, _ = args
    before = _build.launch_counts()["flash_attention_bwd_dq"]
    dq = attn._dq_kernel(*args)
    assert _build.launch_counts()["flash_attention_bwd_dq"] == before + 1
    ref = attn._dq_reference(*args)
    exact = _exact_of(args)[0]
    torch.cuda.synchronize()
    _assert_flash_bwd_close((dq,), (ref,), (exact,))
    assert torch.equal(attn._dq_kernel(*args), dq)
    one = attn._bwd_kernel(q, k, v, out, lse, do, causal, scale)[0]
    if one.float().norm() > 0:
        assert _rel_l2(dq, one) <= 1e-2


@pytest.mark.parametrize("causal,valid", [(True, (150, 150)),
                                          (False, (100, 190)),
                                          (True, (129, 65))])
def test_flash_dq_kernel_validity_window_ends_mid_tile(cuda, causal, valid):
    """Rows past the window get zero dq."""
    args, _ = _split_case(cuda, 2, 256, 256, 128, causal, 99, causal_off=0,
                          valid=valid)
    dq = attn._dq_kernel(*args)
    _assert_flash_bwd_close((dq,), (attn._dq_reference(*args),),
                            (_exact_of(args)[0],))
    assert bool((dq[:, valid[0]:] == 0).all())
    assert torch.equal(attn._dq_kernel(*args), dq)


# -- the fused decode block ----------------------------------------------
#
# Tolerances: y, k_tok and v_tok within 2^-6 of each output's magnitude
# (bf16 outputs, a few ulps: the kernel and the plain version round the
# same values at the same points, and differ by fp32 sums in another
# order and by p rounded against a split's running maximum instead of
# the window's), and within a relative L2 of 1e-2 each.


def _fused_case(cuda, group, d, lengths, ps=16, mpps=20, heads=8, ffn=1376):
    kvh, slots = heads // group, len(lengths)
    hidden = heads * d
    pa_ = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)

    def lin(i, o, seed):
        return _randn((i, o), seed, cuda) * i ** -0.5

    blk = {"ln1_w": 1 + 0.1 * _randn((1, hidden), 50, cuda),
           "wq": lin(hidden, heads * d, 51), "wk": lin(hidden, kvh * d, 52),
           "wv": lin(hidden, kvh * d, 53), "wo": lin(heads * d, hidden, 54),
           "ln2_w": 1 + 0.1 * _randn((1, hidden), 55, cuda),
           "wg": lin(hidden, ffn, 56), "wu": lin(hidden, ffn, 57),
           "wd": lin(ffn, hidden, 58)}
    n_pages = slots * mpps
    pool_k = _randn((n_pages + 1, 3, kvh, ps, d), 59, cuda)
    pool_v = _randn((n_pages + 1, 3, kvh, ps, d), 60, cuda)
    perm = np.random.RandomState(61).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s_, n in enumerate(lengths):
        need = min(-(-n // ps), mpps)
        table[s_, :need] = perm[cursor:cursor + need]
        cursor += need
    cos_t, sin_t = _rope_cos_sin(mpps * ps, d, 500000.0, device=cuda)
    pos = torch.clamp(torch.tensor(lengths, device=cuda), max=mpps * ps - 1)
    return pa_, (_randn((slots, hidden), 62, cuda), blk, pool_k[:, 1],
                 pool_v[:, 1], torch.from_numpy(table).to(cuda),
                 torch.tensor(lengths, dtype=torch.int32, device=cuda)), \
        dict(kind="llama", eps=1e-5, cos=cos_t.reshape(-1, d)[pos],
             sin=sin_t.reshape(-1, d)[pos])


def _assert_fused_close(got, ref):
    for name, g, r in zip(("y", "k_tok", "v_tok"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        assert _maxdiff(g, r) <= 2.0 ** -6 * r.float().abs().max().item(), name
        assert _rel_l2(g, r) <= 1e-2, name


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_block_kernel_matches_plain(cuda, group, d):
    """Lengths 0, 1, ps - 1, ps and the full window (two 256-token
    splits, the second partial) of a strided 3-layer pool view."""
    pa_, args, kw = _fused_case(cuda, group, d, [0, 1, 15, 16, 320])
    before = _build.launch_counts()["fused_block_decode"]
    got = pa_.fused_block_decode(*args, **kw)
    assert _build.launch_counts()["fused_block_decode"] == before + 1
    ref = pa_.fused_block_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


@pytest.mark.parametrize("ln_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fuse_mlp", [True, False])
def test_fused_block_kernel_slot_groups_and_attention_only(cuda, fuse_mlp,
                                                           ln_dtype):
    """Ten slots (two passes of eight over each weight tile), lengths past
    the window clamp to it; without the MLP, y = x + attention; the norm
    weights in bf16 or fp32."""
    lengths = [0, 3, 64, 65, 100, 200, 319, 320, 400, 7]
    pa_, args, kw = _fused_case(cuda, 4, 128, lengths)
    blk = args[1]
    for n in ("ln1_w", "ln2_w"):
        blk[n] = blk[n].to(ln_dtype)
    got = pa_.fused_block_decode(*args, fuse_mlp=fuse_mlp, **kw)
    ref = pa_.fused_block_reference(*args, fuse_mlp=fuse_mlp, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


def test_fused_block_kernel_refuses_what_it_does_not_take(cuda):
    pa_, (x, blk, kp, vp, table, lengths), kw = _fused_case(
        cuda, 2, 64, [0, 5, 16])
    before = _build.launch_counts()["fused_block_decode"]
    with pytest.raises(TypeError, match="bfloat16"):
        pa_.fused_block_decode(x.float(), blk, kp, vp, table, lengths, **kw)
    bad = dict(blk, wq=blk["wq"].T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        pa_.fused_block_decode(x, bad, kp, vp, table, lengths, **kw)
    _, (x3, blk3, kp3, vp3, t3, l3), kw3 = _fused_case(cuda, 3, 64,
                                                        [0, 5, 16], heads=6)
    with pytest.raises(ValueError, match="group"):
        pa_.fused_block_decode(x3, blk3, kp3, vp3, t3, l3, **kw3)
    # the GPT instance: group 1 only; partial_out is not ported
    g_args, g_kw = _gpt_fused_case(cuda, 64, [0, 5, 16])
    gbefore = _build.launch_counts()["fused_block_decode_gpt"]
    gx, gblk, gkp, gvp, gt, gl = g_args
    with pytest.raises(ValueError, match="group 1"):
        pa_.fused_block_decode(gx, gblk, gkp[:, :4], gvp[:, :4], gt, gl,
                               **g_kw)
    with pytest.raises(NotImplementedError, match="tp and spec"):
        pa_.fused_block_decode(*g_args, partial_out=True, fuse_mlp=False,
                               **g_kw)
    bf_vec = dict(gblk, bq=gblk["bq"].to(torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        pa_.fused_block_decode(gx, bf_vec, gkp, gvp, gt, gl, **g_kw)
    assert _build.launch_counts()["fused_block_decode"] == before
    assert _build.launch_counts()["fused_block_decode_gpt"] == gbefore


def _gpt_fused_case(cuda, d, lengths, ps=16, mpps=24, heads=8, ffn=1024):
    """A random GPT layer in the fused layout (bf16 matrices, fp32 norm
    affines and biases) over one layer of a strided 3-layer pool."""
    slots, hidden = len(lengths), heads * d

    def lin(i, o, seed):
        return _randn((i, o), seed, cuda) * i ** -0.5

    def vec(n, seed, base=0.0):
        return base + 0.1 * _randn((1, n), seed, cuda, torch.float32)

    blk = {"ln1_w": vec(hidden, 90, 1.0), "ln1_b": vec(hidden, 91),
           "wq": lin(hidden, hidden, 92), "bq": vec(hidden, 93),
           "wk": lin(hidden, hidden, 94), "bk": vec(hidden, 95),
           "wv": lin(hidden, hidden, 96), "bv": vec(hidden, 97),
           "wo": lin(hidden, hidden, 98), "bo": vec(hidden, 99),
           "ln2_w": vec(hidden, 100, 1.0), "ln2_b": vec(hidden, 101),
           "wu": lin(hidden, ffn, 102), "bu": vec(ffn, 103),
           "wd": lin(ffn, hidden, 104), "bd": vec(hidden, 105)}
    n_pages = slots * mpps
    pool_k = _randn((n_pages + 1, 3, heads, ps, d), 106, cuda)
    pool_v = _randn((n_pages + 1, 3, heads, ps, d), 107, cuda)
    perm = np.random.RandomState(108).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s_, n in enumerate(lengths):
        need = min(-(-n // ps), mpps)
        table[s_, :need] = perm[cursor:cursor + need]
        cursor += need
    return (_randn((slots, hidden), 109, cuda), blk, pool_k[:, 1],
            pool_v[:, 1], torch.from_numpy(table).to(cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda)), \
        dict(kind="gpt", eps=1e-5)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("fuse_mlp", [True, False])
def test_fused_gpt_block_kernel_matches_plain(cuda, d, fuse_mlp):
    """The GPT instance over lengths on and across page (16) and split
    (256) edges and past the 384-position window, ten slots (two passes
    of eight over each weight tile): y, k and v against
    ``fused_block_reference``; one ``fused_block_decode_gpt`` launch and
    no LLaMA-instance launch."""
    lengths = [0, 1, 15, 16, 255, 256, 257, 300, 384, 500]
    args, kw = _gpt_fused_case(cuda, d, lengths)
    counts = _build.launch_counts()
    got = pa.fused_block_decode(*args, fuse_mlp=fuse_mlp, **kw)
    after = _build.launch_counts()
    assert after["fused_block_decode_gpt"] == \
        counts["fused_block_decode_gpt"] + 1
    assert after["fused_block_decode"] == counts["fused_block_decode"]
    ref = pa.fused_block_reference(*args, fuse_mlp=fuse_mlp, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_one_key(cuda, d, causal):
    """sk = 1 under 1000 queries: the softmax over one key is 1 wherever
    the key is visible, so dq and dk are zero in exact arithmetic, and
    the kernels, like the plain version, return the fp32 roundoff of
    dp - delta (far under 2^-10); dv sums dO over the rows that see the
    key, within two bf16 ulps of each element of the plain version's."""
    args, out = _split_case(cuda, 2, 1000, 1, d, causal, 96)
    q, k, v, lse, _, do, _, scale, _, _ = args
    one = attn._bwd_kernel(q, k, v, out, lse, do, causal, scale)
    dq = attn._dq_kernel(*args)
    dk, dv = attn._dkv_kernel(*args)
    assert torch.equal(dk, one[1]) and torch.equal(dv, one[2])
    for t in (one[0], dq, dk):
        assert t.abs().max().item() <= 2.0 ** -10
    rdv = attn._dkv_reference(*args)[1].float()
    assert bool(((dv.float() - rdv).abs() <= 2.0 ** -6 * rdv.abs()
                 + 2.0 ** -9).all())
    assert _rel_l2(dv, rdv) <= 1e-2


# -- the optimizer class API: twins and tree classes on the kernels --------
#
# A small LLaMA on the card (bf16 linears, fp32 norms): each twin's step
# launches its rule's kernel once per group (LAMB: its norm 2 per leaf
# plus at most 2 per group), reads nothing back from the end of the
# backward to the new parameters, and equals the functional step bit
# for bit when fed the same grads from the same state (the update
# kernels are elementwise; the same values give the same bits).

_SMALL_LLAMA = dict(vocab_size=256, hidden_size=128, num_layers=2,
                    num_attention_heads=4, num_kv_heads=2,
                    max_seq_length=64)


def _small_llama(dev, seed=0):
    from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                    llama_model_provider)
    cfg = LlamaConfig(**dict(_SMALL_LLAMA, params_dtype=torch.bfloat16))
    model = llama_model_provider(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.reset_parameters(generator=gen)
    tokens = torch.randint(0, 256, (2, 65), generator=gen, device=dev)
    return model, tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()


def _twin_groups(model, split):
    named = list(model.named_parameters())
    if not split:
        return [p for _, p in named]
    return [{"params": [p for n, p in named if "norm" not in n]},
            {"params": [p for n, p in named if "norm" in n],
             "weight_decay": 0.0}]


@pytest.mark.parametrize("name,kw,kernel,split", [
    ("FusedAdam", dict(lr=1e-3), "fused_adam", False),
    ("FusedAdam", dict(lr=1e-3), "fused_adam", True),
    ("FusedLAMB", dict(lr=1e-3, max_grad_norm=1.0), "fused_lamb1", True),
    ("FusedSGD", dict(lr=0.1, momentum=0.9, nesterov=True), "fused_sgd",
     False),
    ("FusedAdagrad", dict(lr=1e-2), "fused_adagrad", False),
    ("FusedMixedPrecisionLamb", dict(lr=1e-3, step=2), "fused_lamb1",
     False)])
@pytest.mark.parametrize("set_to_none", [True, False])
def test_twin_step_launches_its_kernel_once_per_group_without_sync(
        cuda, name, kw, kernel, split, set_to_none):
    import apex_tpu_torch.optimizers as topt
    model, tokens, labels = _small_llama(cuda)
    opt = getattr(topt, name)(_twin_groups(model, split), **kw)
    assert isinstance(opt, torch.optim.Optimizer)
    groups, leaves = len(opt.param_groups), len(list(model.parameters()))
    for _ in range(2):
        opt.zero_grad(set_to_none=set_to_none)
        model(tokens, labels).backward()
        _build.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts = _build.launch_counts()
        assert counts[kernel] == groups
        if kernel == "fused_lamb1":
            assert 2 * leaves < counts["fused_l2norm"] <= 2 * leaves \
                + 2 * groups
        assert not any(v for k, v in counts.items()
                       if k not in (kernel, "fused_l2norm"))
    torch.cuda.synchronize()
    for p in model.parameters():
        assert torch.isfinite(p).all()


@pytest.mark.parametrize("name,kernels", [
    ("FusedAdam", {"fused_adam": 1}),
    ("FusedLAMB", {"fused_lamb1": 1, "fused_l2norm": None})])
def test_tree_class_step_launches_its_kernels_without_sync(cuda, name,
                                                          kernels):
    import apex_tpu_torch.optimizers as topt
    sizes = {"a": (64, 33), "b": (1001,), "c": (7,)}
    tree = {k: _randn(s, 70 + i, cuda, torch.bfloat16 if len(s) == 2
                      else torch.float32)
            for i, (k, s) in enumerate(sizes.items())}
    opt = getattr(topt, name)(tree, lr=1e-3)
    assert type(opt) is getattr(topt, name)
    grads = {k: _randn(t.shape, 80 + i, cuda, t.dtype)
             for i, (k, t) in enumerate(tree.items())}
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = opt.step(grads, noop_flag=torch.zeros((), device=cuda))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = _build.launch_counts()
    want = {k: (1 + 2 * len(sizes) if v is None else v)
            for k, v in kernels.items()}
    assert {k: v for k, v in counts.items() if v} == want
    assert {k: v.dtype for k, v in out.items()} == {
        k: v.dtype for k, v in tree.items()}


def test_twin_step_equals_functional_step_bit_for_bit(cuda):
    """From one warm state (two functional Adam steps), one
    ``make_train_step`` step and one step of a twin on a copy of the
    model, loaded with that state and fed the functional step's grads:
    master and moments equal bit for bit, one Adam launch each."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import FusedAdam, functional
    tx = functional.fused_adam(lr=1e-3)
    model_f, tokens, labels = _small_llama(cuda)
    batch = {"tokens": tokens, "labels": labels}
    state = train_step.init_train_state(tx, model_f)
    step = train_step.make_train_step(
        lambda m, b: m(b["tokens"], b["labels"]), tx)
    for _ in range(2):
        state, _ = step(state, batch)
    model_t, _, _ = _small_llama(cuda)
    opt = FusedAdam(model_t.parameters(), lr=1e-3)
    offsets = train_step.leaf_offsets(model_f)
    keys = {name: "".join(f"[{k!r}]" for k in name.split("."))
            for name, _ in model_t.named_parameters()}
    master, slots = state.opt.master, state.opt.slots
    sd = opt.state_dict()
    for i, (name, p) in enumerate(model_t.named_parameters()):
        off, size, shape = offsets[keys[name]]
        sd["state"][i] = {"step": 2, "master": master[off:off + size].view(
            shape), **{k: slots[k][off:off + size].view(shape)
                       for k in ("exp_avg", "exp_avg_sq")}}
    opt.load_state_dict(sd)
    with torch.no_grad():
        for name, p in model_t.named_parameters():
            off, size, shape = offsets[keys[name]]
            p.copy_(master[off:off + size].view(shape))
    _build.reset_launch_counts()
    state, _ = step(state, batch)
    assert _build.launch_counts()["fused_adam"] == 1
    views = dict(zip(offsets, state.flat.grad_views))
    for name, p in model_t.named_parameters():
        p.grad = views[keys[name]]
    _build.reset_launch_counts()
    opt.step()
    assert {k: v for k, v in _build.launch_counts().items() if v} == {
        "fused_adam": 1}
    for name, p in model_t.named_parameters():
        off, size, shape = offsets[keys[name]]
        st = opt.state[p]
        assert st["step"] == 3
        assert torch.equal(st.get("master", p),
                           master[off:off + size].view(shape)), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], slots[k][off:off + size].view(
                shape)), (name, k)
