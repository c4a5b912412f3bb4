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
same edges; the rank-partial block's kernel at the tp = 2 and tp = 4
shards, every query group and head dim, 3 and 12 slots, lengths on the
edges of pages, stages and attention runs at page sizes 8 to 128 (and
12 and 100), its launches the same bits, and 40 queued launches on
changing inputs; the optimizer classes: each
twin's and tree class's launches per step with no host sync, and a
twin step equal to a functional step bit for bit; the flash kernels'
mask and dropout instances: the forward with dropout, masked or not,
and both backward routes with a mask and/or dropout against their
plain versions on the same seed operand, the one-pass instances past
their ring (2048 queries, causal offsets, key blocks with no live step,
300 batch-heads; dk and dv the same bits on a second run), and each
instance's keep pattern equal to the plain keep mask bit for bit, also
where the one-pass kernel's ring wraps).

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
    """fp32 operands take the wide forward (#3w) now, within 2e-5 of the
    plain version's max; a head dim past 256 is refused (ROADMAP V9)."""
    q = _randn((1, 2, 16, 64), 7, cuda, torch.float32)
    before = _build.launch_counts()["flash_attention_wide"]
    out = attn.flash_attention(q, q, q, causal=True)
    assert _build.launch_counts()["flash_attention_wide"] == before + 1
    q3 = q.reshape(2, 16, 64)
    ref, _ = attn._fwd_reference(q3, q3, q3, True, 0.125)
    assert _maxdiff(out.reshape(2, 16, 64), ref) <= \
        2e-5 * ref.abs().max().item()
    wide = _randn((1, 2, 16, 320), 7, cuda)
    with pytest.raises(ValueError, match="V9"):
        attn.flash_attention(wide, wide, wide, causal=True)
    qb = q.to(torch.bfloat16).requires_grad_()
    # a mask takes the masked forward, and its backward the masked
    # one-pass instance: finite grads, the plain backward's within 1e-2
    before = _build.launch_counts()
    mask = torch.zeros(1, 1, 16, 16, dtype=torch.bool, device=cuda)
    mask[..., 3:] = True
    out = attn.flash_attention(qb, qb, qb, mask=mask)
    assert _build.launch_counts()["flash_attention_masked"] == \
        before["flash_attention_masked"] + 1
    out.float().sum().backward()
    assert _build.launch_counts()["flash_attention_bwd_masked"] == \
        before["flash_attention_bwd_masked"] + 1
    q3 = qb.detach().reshape(2, 16, 64)
    mask3 = attn._mask3(mask, 1, 2, 16, 16)
    o3, lse = attn._fwd_reference(q3, q3, q3, False, 0.125, mask3=mask3)
    ref = attn._bwd_reference(q3, q3, q3, o3, lse, torch.ones_like(q3),
                              False, 0.125, mask3=mask3)
    want = (ref[0] + ref[1] + ref[2]).reshape(qb.shape)
    assert bool(torch.isfinite(qb.grad).all())
    assert _rel_l2(qb.grad, want) <= 1e-2
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


def test_cuda_engine_refuses_only_a_pool_without_a_kernel_when_built(cuda):
    """An unfused engine on the card checks its pool when it is built,
    not at its first decode step: pages of 8 and 256 now build (the wide
    kernel #7w takes them); a head dim past 256 is refused (V9)."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(vocab_size=256, hidden_size=128, num_layers=1,
                      num_attention_heads=4, num_kv_heads=2,
                      ffn_hidden_size=256, max_seq_length=256)
    for ps in (8, 256):
        InferenceEngine("llama", cfg, _llama_tree(cfg, cuda), slots=2,
                        max_seq=256, page_size=ps, device=cuda,
                        decode_fusion="0")
    wide = LlamaConfig(vocab_size=256, hidden_size=640, num_layers=1,
                       num_attention_heads=2, num_kv_heads=1,
                       ffn_hidden_size=256, max_seq_length=256)
    with pytest.raises(ValueError, match="V9"):
        InferenceEngine("llama", wide, None, slots=2, max_seq=256,
                        page_size=16, device=cuda, decode_fusion="0")


def _llama_tree(cfg, dev, dtype=torch.bfloat16, seed=0):
    """Random LLaMA weights for ``cfg``: linears N(0, 1/fan_in), norms 1,
    the embedding N(0, 1)."""
    from apex_tpu_torch.inference.weights import llama_param_shapes
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    tree: dict = {}
    for path, shape in sorted(llama_param_shapes(cfg).items()):
        t = torch.randn(shape, generator=gen)
        if len(shape) == 1:
            t = torch.ones(shape)
        elif path[0] != "embed_tokens":
            t = t * shape[1] ** -0.5
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.to(dev, dtype)
    return tree


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


#: a ZeRO layout's leaf sizes: 1002577 elements, so a rank's shard is
#: 501289 long at dp = 2 and 250645 at dp = 4 (odd, not a multiple of 4)
#: and the prefetch spans start at odd offsets inside it
ZERO_SIZES = (1000003, 7, 513, 2049, 5)


def _zero_windows(dev, dp, prefetch):
    """A rank's shard length and its prefetch spans' windows ``(offset,
    length)`` inside the shard (one window, the whole shard, for the
    block layout), from the port's own ZeRO layout."""
    from apex_tpu_torch.optimizers import functional
    tree = {f"l{i}": torch.zeros(s, device=dev)
            for i, s in enumerate(ZERO_SIZES)}
    st = functional.fused_adam().init(tree, shard=("data", dp, dp - 1),
                                      prefetch=prefetch)
    wins, off = [], 0
    for _, _, padded in st.span_windows():
        wins.append((off, padded // dp))
        off += padded // dp
    assert off == st.shard_len == st.master.numel()
    return st.shard_len, wins


@pytest.mark.parametrize("prefetch", [0, 3])
@pytest.mark.parametrize("dp", [2, 4])
def test_update_kernels_on_a_zero_shard_and_its_spans(cuda, dp, prefetch):
    """The unscale (#9), Adam (#13) and LAMB's phase 1 (#16) on a rank's
    ZeRO shard (odd length) and on each prefetch span's view of it (odd
    offsets: the kernels' scalar path) against their plain versions, one
    launch a call, a noop bit for bit."""
    fu = _fu()
    length, wins = _zero_windows(cuda, dp, prefetch)
    assert length % 4 != 0
    step = torch.full((), 3.0, device=cuda)
    adam_kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                   weight_decay=0.01, step=step, adam_w_mode=True,
                   grad_scale=0.5)
    lamb_kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                   step=step, bias_correction=True, grad_scale=0.5,
                   grad_averaging=True)
    p = _randn((length,), 60, cuda, torch.float32)
    m = _randn((length,), 61, cuda, torch.float32) * 0.1
    v = _randn((length,), 62, cuda, torch.float32).abs()
    g = _randn((length,), 63, cuda, torch.float32) * 1000
    u = torch.empty(length, device=cuda)
    for off, n in [(0, length)] + (wins if len(wins) > 1 else []):
        sl = slice(off, off + n)
        counts = _build.launch_counts()
        gs = g[sl].clone()
        got, flag = fu.fused_scale(gs, 2.0 ** -16, out=gs)
        ref, rflag = fu._scale_reference(g[sl], torch.full(
            (), 2.0 ** -16, device=cuda), torch.float32)
        assert torch.equal(got, ref) and flag.item() == rflag.item() == 0.0
        hp = fu._adam_hparams(cuda, noop_flag=0.0, bias_correction=True,
                              **{k: adam_kw[k] for k in (
                                  "lr", "beta1", "beta2", "eps",
                                  "weight_decay", "step", "grad_scale")})
        pa_, ma, va = (t[sl].clone() for t in (p, m, v))
        want = fu._adam_kernel_reference(pa_, gs, ma, va, hp, True)
        fu.fused_adam_flat(pa_, gs, ma, va, **adam_kw)
        for a, b in zip((pa_, ma, va), want):
            assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()
        hp = fu._lamb1_hparams(cuda, noop_flag=0.0, **lamb_kw)
        pl, ml, vl = (t[sl] for t in (p, m, v))
        want = fu._lamb1_kernel_reference(pl, gs, ml, vl, hp)
        got = fu.fused_lamb_phase1_flat(pl, gs, ml.clone(), vl.clone(),
                                        u=u[sl], **lamb_kw)
        for a, b in zip(got, want):
            assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()
        snap = [t.clone() for t in (pa_, ma, va)]
        fu.fused_adam_flat(pa_, gs, ma, va, noop_flag=torch.ones(
            (), device=cuda), **adam_kw)
        assert all(torch.equal(a, b) for a, b in zip((pa_, ma, va), snap))
        after = _build.launch_counts()
        for key, k in (("fused_scale", 1), ("fused_adam", 2),
                       ("fused_lamb1", 1)):
            assert after[key] == counts[key] + k, key


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
    # the GPT instance: group 1 only; the rank-partial instance runs
    # without the MLP only
    g_args, g_kw = _gpt_fused_case(cuda, 64, [0, 5, 16])
    gbefore = _build.launch_counts()["fused_block_decode_gpt"]
    gx, gblk, gkp, gvp, gt, gl = g_args
    with pytest.raises(ValueError, match="group 1"):
        pa_.fused_block_decode(gx, gblk, gkp[:, :4], gvp[:, :4], gt, gl,
                               **g_kw)
    with pytest.raises(ValueError, match="fuse_mlp=False"):
        pa_.fused_block_decode(*g_args, partial_out=True, fuse_mlp=True,
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



# -- mask and dropout in the flash kernels ------------------------------
#
# The forward with dropout (#3d, #3md), the one-pass backward with a mask
# and/or dropout (#4m, #4md, #4d) and the split pair's _md instances (#5,
# #6) against their plain versions on the same operands and the same seed
# operand (the keep mask bit for bit, so the only differences are
# rounding: out within 2e-2 and 2^-6 of each row's max, lse 1e-3, grads
# as _assert_flash_bwd_close, the exact float64 gradient with the same
# keep mask); and the keep pattern itself, exactly: with q = 0 every
# live p of a row is equal, so with v = I (sk = d) out[i, j] > 0 where
# (i, j) is kept, and with dO = I (sq = d) dv[j, i] > 0 where (i, j) is
# kept.

def _exact_grads_md(q, k, v, do, causal, scale, mask3, rate, seed3,
                    valid=None, causal_off=None):
    """(dq, dk, dv) in float64 with the mask, the validity window, the
    causal offset (default sk - sq) and the keep mask, p, p̃ and ds
    unrounded."""
    bh, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    q_, k_, v_, do_ = (t.double() for t in (q, k, v, do))
    off = sk - sq if causal_off is None else causal_off
    live = attn._live3(bh, sq, sk, causal, off, valid, mask3, q.device)
    s = (torch.matmul(q_, k_.transpose(1, 2)) * scale).masked_fill(
        ~live, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    keep = attn._keep3(seed3, bh, sq, sk, rate, q.device) if rate else \
        torch.ones_like(p, dtype=torch.bool)
    inv = 1.0 / (1.0 - rate)
    pv = torch.where(keep, p * inv, 0.0)
    delta = (do_ * torch.matmul(pv, v_)).sum(-1, keepdim=True)
    g = torch.where(keep, torch.matmul(do_, v_.transpose(1, 2)) * inv, 0.0)
    ds = p * (g - delta)
    return (scale * torch.matmul(ds, k_),
            scale * torch.matmul(ds.transpose(1, 2), q_),
            torch.matmul(pv.transpose(1, 2), do_))


def _md_mask3(kind, b, h, sq, sk, seed, cuda):
    if kind is None:
        return None
    n = {"per-batch": b, "one": 1, "per-head": b * h}[kind]
    m = np.random.RandomState(seed).rand(n, sq, sk) > 0.6
    m[:, 2, :] = True                       # a fully masked row
    m[0, :, sk // 2:] = True                # keys past a padding length
    return torch.from_numpy(m).to(cuda)


_MD_CASES = [(None, 0.1), ("per-batch", 0.0), ("per-batch", 0.1),
             ("per-head", 0.5), ("one", 0.1)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,rate", _MD_CASES)
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True),
                                          (130, 200, False),
                                          (256, 256, True)])
def test_flash_md_forward_matches_plain(cuda, d, kind, rate, sq, sk, causal):
    b, h = 2, 3
    q, k, v = (_randn((b * h, s, d), seed, cuda)
               for seed, s in ((90, sq), (91, sk), (92, sk)))
    mask3 = _md_mask3(kind, b, h, sq, sk, 93, cuda)
    seed3 = attn._seed_operand(-123457, device=cuda)
    name = ("flash_attention_masked" if not rate
            else "flash_attention_drop" if mask3 is None
            else "flash_attention_masked_drop")
    before = _build.launch_counts()[name]
    got, lse = attn._fwd(q, k, v, causal, d ** -0.5, mask3=mask3, rate=rate,
                         seed3=seed3)
    assert _build.launch_counts()[name] == before + 1
    ref, ref_lse = attn._fwd_reference(q, k, v, causal, d ** -0.5,
                                       mask3=mask3, rate=rate, seed3=seed3)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert (lse - ref_lse).abs().max().item() <= 1e-3


# The forward with dropout (#3d, #3md) is one persistent block an SM
# walking the (batch-head, 128-query block) tiles in a schedule of its
# own; its edges: lengths that cut the tiles and keys fewer than a tile
# (validity windows), causal offsets other than sk - sq, fully masked rows
# and a query block whose key tiles are all dead, fewer tiles than SMs and
# many times more, both head dims, the seed operand's row and column
# offsets and a seed drawn on the card; and the two places the schedule
# changes its order: more (mask, query block) entries than the order
# table holds (1100 per-head masks x 4 query blocks > 4096), and a mask
# over more heads than one L2 group takes (64 heads of 2048 keys: k and v
# over half the L2, so each mask's heads are cut into chunks).
_MD_FWD_EDGES = [
    # label, b, h, sq, sk, causal, causal_off, mask kind, valid, offsets
    ("ragged", 1, 2, 300, 200, False, None, None, None, (0, 0)),
    ("keys under a tile", 2, 3, 250, 77, False, None, "per-batch", None,
     (0, 0)),
    ("causal offset", 1, 2, 200, 300, True, 37, None, None, (0, 0)),
    ("causal negative offset", 1, 2, 300, 300, True, -70, "per-batch",
     None, (0, 0)),
    ("validity window", 1, 3, 390, 330, True, None, "per-head", (260, 301),
     (0, 0)),
    ("a dead query block", 2, 2, 384, 384, False, None, "dead block", None,
     (0, 0)),
    ("few tiles", 1, 1, 256, 256, True, None, None, None, (0, 0)),
    ("many tiles", 8, 40, 300, 300, True, None, "per-batch", None, (0, 0)),
    ("row and column offsets", 2, 2, 200, 260, False, None, "one", None,
     (1000, 77)),
    ("past the order table", 275, 4, 512, 512, False, None, "per-head", None,
     (0, 0)),
    ("heads in chunks", 2, 64, 256, 2048, True, None, "per-batch", None,
     (0, 0)),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("label,b,h,sq,sk,causal,off,kind,valid,offs",
                         _MD_FWD_EDGES, ids=[c[0] for c in _MD_FWD_EDGES])
@pytest.mark.parametrize("device_seed", [False, True])
def test_flash_md_forward_persistent_grid_edges(cuda, d, label, b, h, sq, sk,
                                                causal, off, kind, valid,
                                                offs, device_seed):
    q, k, v = (_randn((b * h, s, d), seed, cuda)
               for seed, s in ((120, sq), (121, sk), (122, sk)))
    if kind == "dead block":
        m = np.random.RandomState(123).rand(b, sq, sk) > 0.6
        m[0, 128:256] = True                # query block 1 all dead
        m[1, 5] = True                      # a fully masked row
        mask3 = torch.from_numpy(m).to(cuda)
    else:
        mask3 = _md_mask3(kind, b, h, sq, sk, 123, cuda)
    seed = (torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                          device=cuda) if device_seed else -424242)
    seed3 = attn._seed_operand(seed, *offs, device=cuda)
    md = dict(causal_off=off, valid=valid, mask3=mask3, rate=0.1,
              seed3=seed3)
    name = ("flash_attention_drop" if mask3 is None
            else "flash_attention_masked_drop")
    before = _build.launch_counts()
    got, lse = attn._fwd(q, k, v, causal, d ** -0.5, **md)
    after = _build.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {name: 1}
    ref, ref_lse = attn._fwd_reference(q, k, v, causal, d ** -0.5, **md)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    dead = ref_lse <= -0.5e30
    assert bool((got[dead] == 0).all()) and bool((lse[dead] == -1e30).all())
    if kind == "dead block":
        assert bool(dead[:h, 128:256].all())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq", [200, 300])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_forward_keep_pattern_ragged_queries(cuda, d, sq, masked):
    """The forward's keep pattern at query counts that are no multiple of
    128 (a persistent block's last query block cut short): q = 0, v = I
    (sk = d), so out[i, j] > 0 exactly where (i, j) is kept and live."""
    bh, s, rate = 5, d, 0.3
    q = torch.zeros(bh, sq, d, dtype=torch.bfloat16, device=cuda)
    k = _randn((bh, s, d), 124, cuda)
    eye = torch.eye(d, dtype=torch.bfloat16, device=cuda).expand(
        bh, d, d).contiguous()
    seed3 = attn._seed_operand(2 ** 31 - 77, 3, 9, device=cuda)
    keep = attn._keep3(seed3, bh, sq, s, rate, cuda)
    mask3 = None
    if masked:
        mask3 = torch.zeros(1, sq, s, dtype=torch.bool, device=cuda)
        mask3[:, :, s - 7:] = True
        mask3[:, 150] = True                # a fully masked row
        keep = keep & ~mask3
    out, _ = attn._fwd(q, k, eye, False, d ** -0.5, mask3=mask3, rate=rate,
                       seed3=seed3)
    torch.cuda.synchronize()
    assert torch.equal(out > 0, keep)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,rate", _MD_CASES)
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True),
                                          (130, 200, False),
                                          (256, 256, True)])
@pytest.mark.parametrize("split", [False, True])
def test_flash_md_backward_matches_plain(cuda, d, kind, rate, sq, sk, causal,
                                         split, monkeypatch):
    b, h = 2, 3
    q, k, v, do = (_randn((b * h, s, d), seed, cuda)
                   for seed, s in ((94, sq), (95, sk), (96, sk), (97, sq)))
    mask3 = _md_mask3(kind, b, h, sq, sk, 98, cuda)
    seed3 = attn._seed_operand(2 ** 31 - 5, device=cuda)
    scale = d ** -0.5
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    out, lse = attn._fwd(q, k, v, causal, scale, **md)
    if split:
        monkeypatch.setattr(attn, "_FUSED_BWD_MAX_BYTES", 0)
    names = (("flash_attention_bwd_dq_md", "flash_attention_bwd_dkv_md")
             if split else ("flash_attention_bwd_masked",) if mask3 is not None
             else ("flash_attention_bwd_drop",))
    before = _build.launch_counts()
    got = attn._bwd(q, k, v, out, lse, do, causal, scale, **md)
    after = _build.launch_counts()
    assert all(after[n] == before[n] + 1 for n in names)
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"]
    ref = attn._bwd_reference(q, k, v, out, lse, do, causal, scale, **md)
    torch.cuda.synchronize()
    _assert_flash_bwd_close(got, ref, _exact_grads_md(
        q, k, v, do, causal, scale, mask3, rate, seed3))


# The split pair's mask and dropout instances (#5md: the persistent
# query-major kernel's dq mode; #6md: the warp-specialized key-major
# kernel's dk/dv mode, its key blocks longest first) at the edges of their
# schedules: key counts that cut the 64-key steps and the 128-key blocks
# (the longest-first order over a ragged last block), a key block and a
# query block all dead, fully masked rows, per-batch, per-head and shared
# masks, causal offsets and validity windows, more blocks than SMs and
# heads in more than one L2 group, the seed operand's offsets and a seed
# drawn on the card.  The split route runs the mask pre-pass once for
# both kernels: its outputs equal the kernels' called alone (each with a
# pre-pass of its own) and a second run's, bit for bit.
_MD_SPLIT_EDGES = [
    # label, b, h, sq, sk, causal, causal_off, mask kind, valid, offsets
    ("ragged keys, longest first", 1, 2, 300, 333, True, None, None, None,
     (0, 0)),
    ("keys under a block", 2, 3, 250, 77, False, None, "per-batch", None,
     (0, 0)),
    ("a dead key block", 2, 2, 384, 384, False, None, "dead keys", None,
     (0, 0)),
    ("the last key tile dead", 2, 2, 256, 300, False, None, "per-batch",
     None, (0, 0)),
    ("a dead query block", 2, 2, 384, 384, False, None, "dead block", None,
     (0, 0)),
    ("per-head, fully masked rows", 1, 3, 256, 256, True, None, "per-head",
     None, (0, 0)),
    ("shared mask", 2, 2, 200, 260, False, None, "one", None, (1000, 77)),
    ("causal offset", 1, 2, 200, 300, True, 37, None, None, (0, 0)),
    ("validity window", 1, 3, 390, 330, True, None, "per-head", (260, 301),
     (0, 0)),
    ("many blocks", 8, 40, 300, 300, True, None, "per-batch", None, (0, 0)),
    ("two L2 groups", 1, 56, 1024, 1024, True, None, None, None, (5, 0)),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("label,b,h,sq,sk,causal,off,kind,valid,offs",
                         _MD_SPLIT_EDGES, ids=[c[0] for c in _MD_SPLIT_EDGES])
@pytest.mark.parametrize("device_seed", [False, True])
def test_flash_md_split_backward_schedule_edges(cuda, d, label, b, h, sq, sk,
                                                causal, off, kind, valid,
                                                offs, device_seed,
                                                monkeypatch):
    q, k, v, do = (_randn((b * h, s, d), seed, cuda)
                   for seed, s in ((130, sq), (131, sk), (132, sk), (133, sq)))
    if kind in ("dead keys", "dead block"):
        m = np.random.RandomState(134).rand(b, sq, sk) > 0.6
        if kind == "dead keys":
            m[:, :, 128:256] = True         # key block 1 dead for every row
        else:
            m[0, 128:256] = True            # query block 1 all dead
        m[1, 5] = True                      # a fully masked row
        mask3 = torch.from_numpy(m).to(cuda)
    else:
        mask3 = _md_mask3(kind, b, h, sq, sk, 134, cuda)
    seed = (torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                          device=cuda) if device_seed else 2 ** 31 - 99)
    seed3 = attn._seed_operand(seed, *offs, device=cuda)
    scale = d ** -0.5
    md = dict(causal_off=off, valid=valid, mask3=mask3, rate=0.1,
              seed3=seed3)
    out, lse = attn._fwd(q, k, v, causal, scale, **md)
    monkeypatch.setattr(attn, "_FUSED_BWD_MAX_BYTES", 0)
    before = _build.launch_counts()
    got = attn._bwd(q, k, v, out, lse, do, causal, scale, **md)
    after = _build.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"flash_attention_bwd_dq_md": 1,
                                          "flash_attention_bwd_dkv_md": 1}
    again = attn._bwd(q, k, v, out, lse, do, causal, scale, **md)
    delta = attn._delta(out, do)
    args = (q, k, v, lse, delta, do, causal, scale)
    alone = (attn._dq_kernel(*args, **md), *attn._dkv_kernel(*args, **md))
    ref = attn._bwd_reference(q, k, v, out, lse, do, causal, scale, **md)
    torch.cuda.synchronize()
    for g_, a_, s_ in zip(got, again, alone):
        assert torch.equal(g_, a_) and torch.equal(g_, s_)
    _assert_flash_bwd_close(got, ref, _exact_grads_md(
        q, k, v, do, causal, scale, mask3, 0.1, seed3, valid,
        causal_off=off))


# The one-pass instances' ring and roles past the short cases above: more
# query steps than ring stages (causal 2048; sq != sk with the causal
# offset), key blocks with no live step (a batch all masked and keys past
# a padding length; a validity window), more blocks than SMs (300
# batch-heads).  Rate 0 without a mask is the plain one-pass kernel, so
# there the mask is per batch.
_MD_LONG = [
    # label, b, h, sq, sk, causal, mask kind, valid
    ("causal 2048", 1, 2, 2048, 2048, True, None, None),
    ("causal offset", 1, 2, 1000, 1536, True, None, None),
    ("a batch all masked", 2, 2, 700, 700, False, "dead batch", None),
    ("validity window", 1, 2, 1100, 1300, True, None, (900, 1000)),
    ("300 batch-heads", 100, 3, 256, 256, True, "per-batch", None),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("label,b,h,sq,sk,causal,kind,valid", _MD_LONG,
                         ids=[c[0] for c in _MD_LONG])
def test_flash_md_one_pass_backward_long(cuda, d, rate, label, b, h, sq, sk,
                                         causal, kind, valid):
    """The one-pass mask/dropout backward against its plain version and
    the exact gradient; dk and dv the same bits on a second run (each
    block writes its keys' once), dq within the rule (its bulk
    reductions add in any order)."""
    if kind is None and not rate:
        kind = "per-batch"
    q, k, v, do = (_randn((b * h, s, d), seed, cuda)
                   for seed, s in ((110, sq), (111, sk), (112, sk), (113, sq)))
    if kind == "dead batch":
        m = np.random.RandomState(114).rand(b, sq, sk) > 0.6
        m[0, :, 300:] = True                # keys past a padding length
        m[1] = True                         # a batch all masked
        mask3 = torch.from_numpy(m).to(cuda)
    else:
        mask3 = _md_mask3(kind, b, h, sq, sk, 114, cuda)
    seed3 = attn._seed_operand(-987654321, device=cuda)
    scale = d ** -0.5
    md = dict(valid=valid, mask3=mask3, rate=rate, seed3=seed3)
    out, lse = attn._fwd(q, k, v, causal, scale, **md)
    name = ("flash_attention_bwd_masked" if mask3 is not None
            else "flash_attention_bwd_drop")
    before = _build.launch_counts()
    got = attn._bwd(q, k, v, out, lse, do, causal, scale, **md)
    after = _build.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {name: 1}
    again = attn._bwd(q, k, v, out, lse, do, causal, scale, **md)
    ref = attn._bwd_reference(q, k, v, out, lse, do, causal, scale, **md)
    torch.cuda.synchronize()
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    _assert_flash_bwd_close(got, ref, _exact_grads_md(
        q, k, v, do, causal, scale, mask3, rate, seed3, valid))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seed,bh", [(0, 3), (-1, 40), (2 ** 31 - 1, 300),
                                     (-2 ** 31, 7)])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_keep_pattern_is_the_plain_keep_mask(cuda, d, seed, bh,
                                                   masked):
    """The forward's (v = I) and the backward's (dO = I: dv) keep
    patterns equal the plain keep mask exactly, on both backward routes;
    the split dq kernel against its plain version."""
    s = d
    rate = 0.3
    q = torch.zeros(bh, s, d, dtype=torch.bfloat16, device=cuda)
    k = _randn((bh, s, d), 99, cuda)
    eye = torch.eye(d, dtype=torch.bfloat16, device=cuda).expand(
        bh, d, d).contiguous()
    seed3 = attn._seed_operand(seed, device=cuda)
    keep = attn._keep3(seed3, bh, s, s, rate, cuda)
    mask3 = None
    if masked:
        mask3 = torch.zeros(1, s, s, dtype=torch.bool, device=cuda)
        mask3[:, :, s - 5:] = True
        keep = keep & ~mask3
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    out, lse = attn._fwd(q, k, eye, False, d ** -0.5, **md)
    torch.cuda.synchronize()
    assert torch.equal(out > 0, keep)
    for split in (False, True):
        saved = attn._FUSED_BWD_MAX_BYTES
        attn._FUSED_BWD_MAX_BYTES = 0 if split else saved
        try:
            dq, dk, dv = attn._bwd(q, k, eye, out, lse, eye, False,
                                   d ** -0.5, **md)
        finally:
            attn._FUSED_BWD_MAX_BYTES = saved
        torch.cuda.synchronize()
        assert torch.equal(dv.transpose(1, 2) > 0, keep)
        if split:
            ref_dq = attn._dq_reference(q, k, eye, lse, attn._delta(out, eye),
                                        eye, False, d ** -0.5, **md)
            assert _rel_l2(dq, ref_dq) <= 1e-2


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_keep_pattern_is_the_plain_keep_mask_causal_2048(cuda, d,
                                                               masked):
    """The one-pass backward's keep pattern where its ring wraps: causal,
    2048 queries and keys, q = 0; dO one-hot on a window of d queries
    (query w0 + i to column i), so dv[j, i] > 0 exactly where query w0 + i
    keeps key j, window by window."""
    bh, s, rate = 3, 2048, 0.3
    q = torch.zeros(bh, s, d, dtype=torch.bfloat16, device=cuda)
    k = _randn((bh, s, d), 115, cuda)
    v = _randn((bh, s, d), 116, cuda)
    seed3 = attn._seed_operand(-2 ** 31 + 7, device=cuda)
    mask3 = None
    if masked:
        mask3 = torch.zeros(1, s, s, dtype=torch.bool, device=cuda)
        mask3[:, :, s - 200:] = True        # keys past a padding length
    live = attn._live3(bh, s, s, True, 0, None, mask3, cuda)
    keep = attn._keep3(seed3, bh, s, s, rate, cuda) & live
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    out, lse = attn._fwd(q, k, v, True, d ** -0.5, **md)
    eye = torch.eye(d, dtype=torch.bfloat16, device=cuda)
    for w0 in range(0, s, d):
        do = torch.zeros(bh, s, d, dtype=torch.bfloat16, device=cuda)
        do[:, w0:w0 + d] = eye
        _, _, dv = attn._bwd(q, k, v, out, lse, do, True, d ** -0.5, **md)
        torch.cuda.synchronize()
        assert torch.equal(dv.transpose(1, 2) > 0, keep[:, w0:w0 + d]), w0


def test_flash_md_refuses_what_it_does_not_take(cuda):
    q = _randn((2, 16, 32), 7, cuda)
    seed3 = attn._seed_operand(1, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attn._fwd(q, q, q, False, 0.2, rate=0.1, seed3=seed3)
    q = _randn((2, 16, 64), 7, cuda)
    with pytest.raises(ValueError, match="seed operand"):
        attn._fwd(q, q, q, False, 0.2, rate=0.1, seed3=seed3.cpu())


def test_flash_attention_dropout_autograd_launches_the_md_instances(cuda):
    """The public entry with a mask and dropout, seeded by a tensor on
    the card: one masked-dropout forward, one masked backward; grads
    against the plain route's."""
    b, h, s, d = 2, 2, 96, 64
    q, k, v = (_randn((b, h, s, d), seed, cuda).requires_grad_()
               for seed in (100, 101, 102))
    mask = torch.zeros(b, 1, s, s, dtype=torch.bool, device=cuda)
    mask[1, :, :, 60:] = True
    seed = torch.tensor(77, dtype=torch.int32, device=cuda)
    _build.reset_launch_counts()
    out = attn.flash_attention(q, k, v, mask=mask, dropout_rate=0.1,
                               dropout_seed=seed)
    out.float().sum().backward()
    counts = {n: c for n, c in _build.launch_counts().items() if c}
    assert counts == {"flash_attention_masked_drop": 1,
                      "flash_attention_bwd_masked": 1}
    q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, k, v))
    attn.flash_attention(q2, k2, v2, mask=mask, dropout_rate=0.1,
                         dropout_seed=77, use_kernel=False).sum().backward()
    for g_, r in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        assert _rel_l2(g_, r) <= 2e-2


# --- the loss side of training: no kernel of the library, plain PyTorch
# on the card (the fused LM head's chunks, its fp32 weight grad, remat's
# generator replay); nothing here needs the build


def _head_case(n, h, v, seed, pad_every):
    rng = np.random.RandomState(seed)
    hid = torch.from_numpy(rng.randn(n, h).astype(np.float32))
    w = torch.from_numpy((rng.randn(v, h) * 0.3).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, v, size=n))
    lab[::pad_every] = -100
    return hid, w, lab


def _head_grads(fx, hid, w, lab, dev, dtype, **kw):
    h = hid.to(dev, dtype).requires_grad_()
    wt = w.to(dev, dtype).requires_grad_()
    loss = fx.fused_lm_head_cross_entropy(h, wt, lab.to(dev), **kw)
    loss.sum().backward()
    return [t.detach().float().cpu() for t in (loss, h.grad, wt.grad)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab_chunk", [0, 64])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_lm_head_on_the_card_matches_the_cpu_route(cuda, dtype,
                                                         vocab_chunk,
                                                         smoothing):
    """The fused head on CUDA tensors (the bf16 weight grad accumulated
    in fp32 by the GEMM itself) against the same op on CPU tensors: 300
    tokens in chunks of 64 (a padded last chunk), padding rows."""
    fx = importlib.import_module("apex_tpu_torch.ops.fused_lm_xent")
    hid, w, lab = _head_case(300, 64, 256, 5, 7)
    kw = dict(token_chunk=64, vocab_chunk=vocab_chunk, smoothing=smoothing)
    got = _head_grads(fx, hid, w, lab, cuda, dtype, **kw)
    want = _head_grads(fx, hid, w, lab, torch.device("cpu"), dtype, **kw)
    assert torch.all(got[0][::7] == 0) and torch.all(got[1][::7] == 0)
    if dtype == torch.float32:
        for g_, r in zip(got, want):
            torch.testing.assert_close(g_, r, rtol=0, atol=1e-4)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-2, atol=2e-2)
        for g_, r in zip(got[1:], want[1:]):
            assert (g_ - r).abs().max() <= 1.6e-2 * r.abs().max()


def test_fused_lm_head_weight_grad_is_an_fp32_gemm_in_place(cuda):
    """``_wgrad_add_`` on bf16 operands: the GEMM writes fp32 into ``dw``
    itself (no other buffer), ``dw + g^T h`` as the upcast product."""
    fx = importlib.import_module("apex_tpu_torch.ops.fused_lm_xent")
    g = _randn((512, 384), 41, cuda)
    h = _randn((512, 256), 42, cuda)
    dw = _randn((384, 256), 43, cuda, torch.float32)
    want = dw.double() + g.double().T @ h.double()
    ptr = dw.data_ptr()
    out = fx._wgrad_add_(dw, g, h)
    assert out.data_ptr() == ptr and out.dtype == torch.float32
    torch.testing.assert_close(dw.double(), want, rtol=1e-5, atol=1e-4)


def test_remat_replays_a_cuda_generator(cuda):
    """``utils.remat`` over a function drawing hidden-dropout masks and an
    attention seed from a CUDA generator: the grads and the generator's
    final state equal the run without recompute."""
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        attention_seed, hidden_dropout)
    from apex_tpu_torch.utils import remat
    w = _randn((64, 64), 44, cuda, torch.float32)

    def layer(x, gen):
        y = hidden_dropout(torch.tanh(x @ w), 0.1, False, gen)
        return y * attention_seed(gen, x.device).float().sign()

    def run(recompute):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(9)
        x = _randn((32, 64), 45, cuda, torch.float32).requires_grad_()
        y = remat(layer, x, gen, generator=gen) if recompute else layer(x,
                                                                        gen)
        y = remat(layer, y, gen, generator=gen) if recompute else layer(y,
                                                                        gen)
        y.square().sum().backward()
        return y.detach(), x.grad, gen.get_state()

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


# --- the wide family (#3w, #5w, #6w: csrc/flash_wide.cu; #7w:
# csrc/paged_wide.cu): fp32, bf16 and fp16 operands at any head dim up
# to 256; #3w and #5w on the tensor cores (16-bit at head dims that are
# multiples of 8, fp32 up to 128 as three bf16 planes), the rest on the
# CUDA cores.  Tolerances: an fp32 kernel against its fp32
# plain version (TF32 off) within 2e-5 of max|ref| for out and lse and
# 1e-4 for the grads (the sums run in another order, exp2 is ex2.approx);
# 16-bit operands as the bf16 instances' card tests hold them (out 2e-2
# absolute, lse 1e-3; the grads within 1e-2 relative L2 of the plain
# version, and by element or against the exact gradient).

_WIDE_TYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
               "fp16": torch.float16}


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _live_rows(lse):
    return lse > -1e29


def _assert_wide_fwd(out, lse, ref, ref_lse, dtype):
    assert out.dtype == dtype and lse.dtype == torch.float32
    live = _live_rows(ref_lse)
    assert torch.equal(_live_rows(lse), live)
    assert bool((lse[~live] == -1e30).all())
    assert bool((out[~live] == 0).all())
    if dtype == torch.float32:
        assert _maxdiff(out, ref) <= 2e-5 * ref.abs().max().item()
        assert _maxdiff(lse[live], ref_lse[live]) <= \
            2e-5 * ref_lse[live].abs().max().item()
    else:
        assert _maxdiff(out, ref) <= 2e-2
        assert _maxdiff(lse[live], ref_lse[live]) <= 1e-3


def _assert_wide_bwd(got, ref, exact, dtype):
    for g, r, x in zip(got, ref, exact):
        assert g.dtype == dtype
        if dtype == torch.float32:
            assert _maxdiff(g, r) <= 1e-4 * r.abs().max().item()
            continue
        assert _rel_l2(g, r) <= 1e-2
        g32, r32 = g.float(), r.float()
        by_element = bool(((g32 - r32).abs()
                           <= 2.0 ** -6 * r32.abs() + 2.0 ** -9).all())
        ge, re = g.double() - x, r.double() - x
        by_exact = bool(ge.norm() <= 1.05 * re.norm()) and bool(
            ge.abs().max() <= 1.25 * re.abs().max())
        assert by_element or by_exact


def _wide_run(q, k, v, do, causal, scale, **md):
    """#3w, then #5w and #6w on its output: each launched once; the pair
    a second time, the same bits."""
    before = _build.launch_counts()
    out, lse = attn._fwd_wide(q, k, v, causal, scale, **md)
    delta = attn._delta(out, do)
    args = (q, k, v, lse, delta, do, causal, scale)
    dq = attn._dq_wide(*args, **md)
    dk, dv = attn._dkv_wide(*args, **md)
    after = _build.launch_counts()
    for name in ("flash_attention_wide", "flash_attention_wide_dq",
                 "flash_attention_wide_dkv"):
        assert after[name] == before[name] + 1
    again = (attn._dq_wide(*args, **md), *attn._dkv_wide(*args, **md))
    torch.cuda.synchronize()
    for a, b in zip((dq, dk, dv), again):
        assert torch.equal(a, b)
    return out, lse, (dq, dk, dv)


_WIDE_MD = [(None, 0.0), ("per-batch", 0.0), ("one", 0.1), (None, 0.2)]


@pytest.mark.parametrize("dt", list(_WIDE_TYPES))
@pytest.mark.parametrize("d", [16, 36, 48, 80, 96, 100, 160, 200, 256])
@pytest.mark.parametrize("kind,rate", _WIDE_MD)
@pytest.mark.parametrize("sq,sk", [(100, 130), (130, 197)])
def test_wide_flash_matches_plain(cuda, no_tf32, dt, d, kind, rate, sq, sk):
    """Causal with the offset sk - sq, a per-batch mask with a fully
    masked row and dead keys, a shared mask broadcast over every
    batch-head, dropout: #3w against ``_fwd_reference``, #5w and #6w
    against ``_dq_reference`` / ``_dkv_reference``; the pair repeats bit
    for bit.  Head dims 36 and 100 are rows TMA cannot copy at 16 bits
    (copied by threads) and planes padded to 40 and 104 at fp32; 200 the
    256 bucket (fp32: the CUDA-core kernels).  130 queries and 197 keys
    end inside a tile and a step of every instance."""
    dtype = _WIDE_TYPES[dt]
    b, h = 2, 3
    q, k, v, do = (_randn((b * h, s, d), 110 + i, cuda, dtype)
                   for i, s in enumerate((sq, sk, sk, sq)))
    mask3 = _md_mask3(kind, b, h, sq, sk, 114, cuda)
    seed3 = attn._seed_operand(-77, device=cuda) if rate else None
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    scale = d ** -0.5
    out, lse, grads = _wide_run(q, k, v, do, True, scale, **md)
    ref, ref_lse = attn._fwd_reference(q, k, v, True, scale, mask3=mask3,
                                       rate=rate, seed3=seed3)
    # the backward's plain versions on the kernels' own inputs
    args = (q, k, v, lse, attn._delta(out, do), do, True, scale)
    want = (attn._dq_reference(*args, **md), *attn._dkv_reference(*args,
                                                                   **md))
    torch.cuda.synchronize()
    _assert_wide_fwd(out, lse, ref, ref_lse, dtype)
    exact = _exact_grads_md(q, k, v, do, True, scale, mask3, rate, seed3)
    _assert_wide_bwd(grads, want, exact, dtype)


@pytest.mark.parametrize("dt", list(_WIDE_TYPES))
@pytest.mark.parametrize("d", [80, 256])
@pytest.mark.parametrize("causal,off,valid", [(True, -5, None),
                                              (True, 40, (90, 120)),
                                              (False, None, (70, 33))])
def test_wide_flash_offsets_and_windows(cuda, no_tf32, dt, d, causal, off,
                                        valid):
    """Causal offsets either side of 0 and validity windows that cut the
    tiles (rows past the window: 0 and lse -1e30)."""
    dtype = _WIDE_TYPES[dt]
    q, k, v, do = (_randn((4, s, d), 120 + i, cuda, dtype)
                   for i, s in enumerate((100, 130, 130, 100)))
    kw = dict(causal_off=off, valid=valid)
    scale = 0.7 * d ** -0.5
    out, lse = attn._fwd_wide(q, k, v, causal, scale, **kw)
    ref, ref_lse = attn._fwd_reference(q, k, v, causal, scale, **kw)
    args = (q, k, v, lse, attn._delta(out, do), do, causal, scale)
    got = (attn._dq_wide(*args, **kw), *attn._dkv_wide(*args, **kw))
    want = (attn._dq_reference(*args, **kw),
            *attn._dkv_reference(*args, **kw))
    torch.cuda.synchronize()
    _assert_wide_fwd(out, lse, ref, ref_lse, dtype)
    exact = _exact_grads_md(q, k, v, do, causal, scale, None, 0.0, None,
                            valid=valid, causal_off=off)
    _assert_wide_bwd(got, want, exact, dtype)


@pytest.mark.parametrize("dt", list(_WIDE_TYPES))
@pytest.mark.parametrize("d", [80, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_wide_flash_keep_pattern_is_the_plain_keep_mask(cuda, dt, d, masked):
    """#3w's (v = I), #6w's (dO = I: dv) keep patterns equal the plain
    keep mask exactly; #5w's dq within 1e-2 relative L2 of its plain
    version on the same bits."""
    dtype = _WIDE_TYPES[dt]
    s, bh, rate = d, 5, 0.3
    q = torch.zeros(bh, s, d, dtype=dtype, device=cuda)
    k = _randn((bh, s, d), 130, cuda, dtype)
    eye = torch.eye(d, dtype=dtype, device=cuda).expand(bh, d, d).contiguous()
    seed3 = attn._seed_operand(2 ** 31 - 9, 1000, 77, device=cuda)
    keep = attn._keep3(seed3, bh, s, s, rate, cuda)
    mask3 = None
    if masked:
        mask3 = torch.zeros(1, s, s, dtype=torch.bool, device=cuda)
        mask3[:, :, s - 5:] = True
        keep = keep & ~mask3
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    out, lse = attn._fwd_wide(q, k, eye, False, d ** -0.5, **md)
    delta = attn._delta(out, eye)
    args = (q, k, eye, lse, delta, eye, False, d ** -0.5)
    dq = attn._dq_wide(*args, **md)
    _, dv = attn._dkv_wide(*args, **md)
    ref_dq = attn._dq_reference(*args, **md)
    torch.cuda.synchronize()
    assert torch.equal(out > 0, keep)
    assert torch.equal(dv.transpose(1, 2) > 0, keep)
    assert _rel_l2(dq, ref_dq) <= 1e-2


@pytest.mark.parametrize("dt", list(_WIDE_TYPES))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sk", [130, 256])
def test_wide_dkv_dead_key_blocks(cuda, no_tf32, dt, d, sk):
    """#6w over a padding mask whose last key blocks are masked for every
    query (each batch's length, 64-key blocks past it whole): those
    blocks are skipped, their keys' dk and dv 0, the rest against
    ``_dkv_reference``; at sk 256 the mask's rows are read four bytes at
    a time, at 130 byte by byte."""
    dtype = _WIDE_TYPES[dt]
    b, h, sq = 2, 2, 96
    q, k, v, do = (_randn((b * h, s, d), 170 + i, cuda, dtype)
                   for i, s in enumerate((sq, sk, sk, sq)))
    lengths = torch.tensor([60, sk - 70], device=cuda)
    mask3 = (torch.arange(sk, device=cuda)[None, None, :]
             >= lengths[:, None, None]).expand(b, sq, sk).contiguous()
    seed3 = attn._seed_operand(5, device=cuda)
    md = dict(mask3=mask3, rate=0.1, seed3=seed3)
    scale = d ** -0.5
    out, lse = attn._fwd_wide(q, k, v, False, scale, **md)
    args = (q, k, v, lse, attn._delta(out, do), do, False, scale)
    got = attn._dkv_wide(*args, **md)
    want = attn._dkv_reference(*args, **md)
    torch.cuda.synchronize()
    dead = mask3[:, 0, :].repeat_interleave(h, dim=0)
    for g, r in zip(got, want):
        assert bool((g[dead] == 0).all())
        if dtype == torch.float32:
            assert _maxdiff(g, r) <= 1e-4 * r.abs().max().item()
        else:
            assert _rel_l2(g, r) <= 1e-2


@pytest.mark.parametrize("dt", list(_WIDE_TYPES))
def test_wide_kernels_by_type_and_head_dim(cuda, dt):
    """Which kernels #3w, #5w and #6w launch, by the operand code their
    wrappers hand the C entries (``_wide_tc_operands``; the entries run
    what the code says), at every head dim 1..256: the tensor cores
    wherever ``_wide_on_tensor_cores`` says (16-bit as it is, fp32 up to
    128 as three bf16 planes), the CUDA-core kernels kept for fp32 past
    128 (fp32 as it is); fp32 planes past 128, which no tile holds, the C
    entries of the forward and of dk/dv refuse.
    ``test_wide_flash_matches_plain`` holds them against the plain
    versions (fp32 at d 160, 200, 256; 16-bit rows copied by threads at d
    36 and 100)."""
    dtype = _WIDE_TYPES[dt]
    code = attn._WIDE_DTYPES[dtype]
    on_tc = []
    for d in range(1, 257):
        x = torch.zeros(1, 2, d, dtype=dtype, device=cuda)
        ops, got = attn._wide_tc_operands(code, (x, x, x))
        if got == attn._WIDE_F32_PLANES:
            for t in ops:
                assert t.dtype == torch.bfloat16 and t.is_cuda
                assert tuple(t.shape) == (3, 1, 2, d + (-d % 8))
        else:
            assert got == code and all(t is x for t in ops)
        if dtype != torch.float32 or got == attn._WIDE_F32_PLANES:
            on_tc.append(d)
    assert on_tc == [d for d in range(1, 257)
                     if attn._wide_on_tensor_cores(dtype, d)]
    assert on_tc == list(range(1, 129 if dtype == torch.float32 else 257))
    if dtype == torch.float32:
        x = torch.zeros(1, 2, 200, device=cuda)
        planes = attn._split_kernel(x)
        out = torch.empty_like(x)
        lse = torch.empty(1, 2, device=cuda)
        err = _build.library().apex_flash_wide_fwd(
            planes.data_ptr(), planes.data_ptr(), planes.data_ptr(), None,
            None, out.data_ptr(), lse.data_ptr(), 1, 2, 2, 200, 1, 0, 2, 2,
            1, 0, 1.0, 1.0, attn._WIDE_F32_PLANES, _build.stream_ptr(cuda))
        torch.cuda.synchronize()
        assert err != 0
        stats = torch.zeros(1, 2, device=cuda)
        dk, dv = torch.empty_like(x), torch.empty_like(x)
        err = _build.library().apex_flash_wide_dkv(
            planes.data_ptr(), planes.data_ptr(), planes.data_ptr(),
            planes.data_ptr(), stats.data_ptr(), stats.data_ptr(), None,
            None, dk.data_ptr(), dv.data_ptr(), 1, 2, 2, 200, 1, 0, 2, 2, 1,
            0, 1.0, 1.0, 1.0, attn._WIDE_F32_PLANES, _build.stream_ptr(cuda))
        torch.cuda.synchronize()
        assert err != 0


@pytest.mark.parametrize("dt", ["bf16", "fp16"])
@pytest.mark.parametrize("d", [36, 37, 64, 256])
def test_wide_flash_operand_alignment(cuda, dt, d):
    """16-bit operands one element past an aligned address take the
    rows TMA cannot read (d 36: element pairs 2-byte aligned, d 37 odd;
    d 64 and 256, 16-byte multiples at a 2-byte address) as they are,
    copied by threads: #3w, #5w and #6w against the plain versions."""
    dtype = _WIDE_TYPES[dt]
    bh, s = 4, 70

    def shifted(seed):
        x = _randn((bh * s * d + 1,), seed, cuda, dtype)[1:]
        return x.view(bh, s, d)

    q, k, v, do = (shifted(160 + i) for i in range(4))
    assert q.data_ptr() % 4 == 2 and q.is_contiguous()
    scale = d ** -0.5
    out, lse = attn._fwd_wide(q, k, v, True, scale)
    ref, ref_lse = attn._fwd_reference(q, k, v, True, scale)
    args = (q, k, v, lse, attn._delta(out, do), do, True, scale)
    dq = attn._dq_wide(*args)
    want = attn._dq_reference(*args)
    dkv = attn._dkv_wide(*args)
    want_dkv = attn._dkv_reference(*args)
    torch.cuda.synchronize()
    _assert_wide_fwd(out, lse, ref, ref_lse, dtype)
    assert _rel_l2(dq, want) <= 1e-2
    for got, ref_g in zip(dkv, want_dkv):
        assert _rel_l2(got, ref_g) <= 1e-2


@pytest.mark.parametrize("d", [1, 36, 64, 100, 128])
def test_wide_split_kernel_is_the_plain_split(cuda, d):
    """The fp32 operands' split into three bf16 planes on the card
    (``apex_flash_wide_split``) against ``_split_planes`` bit for bit,
    over values across the exponent range, zeros and signs; the padding
    columns 0."""
    rng = np.random.RandomState(d)
    x = rng.randn(3, 77, d) * np.exp2(rng.randint(-40, 40, (3, 77, d)))
    x[0, 0] = 0.0
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    got = attn._split_kernel(x)
    want = attn._split_planes(x.cpu())
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, 3, 77, d + (-d % 8))
    assert torch.equal(got.cpu().view(torch.int16),
                       want.view(torch.int16))


@pytest.mark.parametrize("dt", list(_WIDE_TYPES))
def test_flash_attention_takes_the_route(cuda, no_tf32, dt):
    """The public entry on the route of ``_flash_route``: bf16 at d 80
    pads to the 128 instances (#3d, then #4d, dropout), bf16 at d 32 with
    a mask pads to 64 (#3md, #4md), fp32 and fp16 at any d and bf16 at
    d 256 run #3w then #5w + #6w; grads against the plain route's."""
    dtype = _WIDE_TYPES[dt]
    cases = [(80, None, 0.1), (32, "mask", 0.1), (256, None, 0.0)]
    for d, masked, rate in cases:
        b, h, s = 2, 2, 96
        q, k, v = (_randn((b, h, s, d), seed, cuda, dtype).requires_grad_()
                   for seed in (140, 141, 142))
        mask = None
        if masked:
            mask = torch.zeros(b, 1, s, s, dtype=torch.bool, device=cuda)
            mask[1, :, :, 60:] = True
        kw = dict(mask=mask, dropout_rate=rate, dropout_seed=5,
                  causal=mask is None)
        _build.reset_launch_counts()
        attn.flash_attention(q, k, v, **kw).float().sum().backward()
        counts = {n: c for n, c in _build.launch_counts().items() if c}
        if dtype != torch.bfloat16 or d > 128:
            want = {"flash_attention_wide": 1, "flash_attention_wide_dq": 1,
                    "flash_attention_wide_dkv": 1}
        elif masked:
            want = {"flash_attention_masked_drop": 1,
                    "flash_attention_bwd_masked": 1}
        else:
            want = {"flash_attention_drop": 1, "flash_attention_bwd_drop": 1}
        assert counts == want, (d, counts)
        q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, k, v))
        attn.flash_attention(q2, k2, v2, use_kernel=False,
                             **kw).sum().backward()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for g_, r in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
            assert g_.shape == r.shape and _rel_l2(g_, r) <= tol


def _wide_paged_case(cuda, lengths, group, d, ps, mpps, dtype, kvh=2,
                     seed=150):
    """As ``_paged_case`` in ``dtype``: only the live pages (and a trash
    page) in a pool of two layers, layer 1's strided view."""
    slots = len(lengths)
    need = [min(-(-max(n, 0) // ps), mpps) for n in lengths]
    n_pages = sum(need)
    pool_k = _randn((n_pages + 1, 2, kvh, ps, d), seed, cuda, dtype)
    pool_v = _randn((n_pages + 1, 2, kvh, ps, d), seed + 1, cuda, dtype)
    perm = np.random.RandomState(seed + 2).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(need):
        table[s, :n] = perm[cursor:cursor + n]
        cursor += n
    table = torch.from_numpy(table).to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = _randn((slots, kvh * group, d), seed + 3, cuda, dtype)
    return q, pool_k[:, 1], pool_v[:, 1], table, lens


@pytest.mark.parametrize("dt", list(_WIDE_TYPES))
@pytest.mark.parametrize("group", [3, 5, 7, 16, 32])
@pytest.mark.parametrize("d", [80, 96, 256])
@pytest.mark.parametrize("ps", [8, 24, 256])
def test_wide_paged_kernel_matches_plain(cuda, dt, group, d, ps):
    """#7w over groups, head dims, page sizes and types the instance has
    no kernel for, one layer's strided view of a two-layer pool: lengths
    0, on and across page edges, the whole window and past it; each slot
    within its own max (2e-5 fp32, 2^-6 16-bit), an empty slot 0, a
    second call the same bits.  The host predicate sends every such pool
    to the TMA modes but fp32 past head dim 128."""
    dtype = _WIDE_TYPES[dt]
    mpps = max(2, 1200 // ps)
    win = mpps * ps
    lengths = [0, 1, ps, ps + 1, win // 2, win, win + 9]
    case = _wide_paged_case(cuda, lengths, group, d, ps, mpps, dtype)
    q, kp, vp, table, lens = case
    assert kp.stride(0) != kp[0].numel()          # a strided layer view
    assert pa._wide_paged_tma(dtype, d, ps, kp.stride(0), kp.data_ptr(),
                              vp.data_ptr()) == (
        dtype != torch.float32 or d <= 128)
    before = _build.launch_counts()
    got = pa.paged_decode_attention(q, kp, vp, table, lens)
    after = _build.launch_counts()
    assert after["paged_attention_wide"] == before["paged_attention_wide"] + 1
    assert after["paged_attention"] == before["paged_attention"]
    again = pa.paged_decode_attention(q, kp, vp, table, lens)
    ref = pa.paged_decode_reference(q, kp, vp, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    assert _slot_errors(got, ref).max().item() <= tol
    assert torch.equal(got, again)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("slots", [1, 64])
def test_wide_paged_kernel_splits_and_a_float_query(cuda, slots):
    """A long window in many splits (merged in the launch, the counters
    left zero) and an fp32 query against a bf16 pool (read in fp32, the
    output in the query's type)."""
    rng = np.random.RandomState(slots)
    lengths = [int(n) for n in rng.randint(0, 4100, size=slots)]
    lengths[0] = 4096
    q, kp, vp, table, lens = _wide_paged_case(cuda, lengths, 4, 64, 64, 64,
                                              torch.bfloat16)
    qf = q.float()
    got = pa.paged_decode_attention(qf, kp, vp, table, lens)
    ref = pa.paged_decode_reference(qf, kp, vp, table, lens, 0.125)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _slot_errors(got, ref).max().item() <= 2.0 ** -6
    stream = _build.stream_ptr(cuda)
    assert int(pa._counters(cuda, stream, 1).abs().sum().item()) == 0


def _assert_wide_paged(case, tma):
    """#7w on the mode the host predicate names (``tma``): one
    ``paged_attention_wide`` launch and no ``paged_attention`` launch a
    call, the output in the query's type, each slot within its own max
    (2e-5 for an fp32 query on an fp32 pool, else 2^-6: p is rounded to
    the pool's type, or the output to the query's), an empty slot 0, the
    same bits on a second call."""
    q, kp, vp, table, lens = case
    d, ps = kp.shape[3], kp.shape[2]
    assert pa._wide_paged_tma(kp.dtype, d, ps, kp.stride(0), kp.data_ptr(),
                              vp.data_ptr()) == tma
    before = _build.launch_counts()
    got = pa.paged_decode_attention(q, kp, vp, table, lens)
    after = _build.launch_counts()
    assert after["paged_attention_wide"] == before["paged_attention_wide"] + 1
    assert after["paged_attention"] == before["paged_attention"]
    again = pa.paged_decode_attention(q, kp, vp, table, lens)
    ref = pa.paged_decode_reference(q, kp, vp, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    fp32 = q.dtype == kp.dtype == torch.float32
    assert _slot_errors(got, ref).max().item() <= (2e-5 if fp32
                                                   else 2.0 ** -6)
    assert torch.equal(got, again)
    empty = (lens <= 0).nonzero().flatten()
    assert bool((got[empty] == 0).all())


def _wide_mode_case(cuda, pool, group, d, ps, query=None, seed=170):
    """A pool of type ``pool`` (strided layer view, only the live pages),
    lengths 0, on and across a page edge, across the split plan's first
    split and the whole 1200-odd position window; q of type ``query``
    (the pool's by default)."""
    mpps = max(2, 1200 // ps)
    win = mpps * ps
    lengths = [0, 1, ps, ps + 1, 700, win - 1, win, win + 9]
    q, kp, vp, table, lens = _wide_paged_case(
        cuda, lengths, group, d, ps, mpps, _WIDE_TYPES[pool], seed=seed)
    if query is not None:
        q = _randn(tuple(q.shape), seed + 3, cuda, _WIDE_TYPES[query])
    return q, kp, vp, table, lens


# (pool, query, group, head dim, page): each new TMA mode -- fp16 at #7's
# groups and head dims, groups past 8 (and row chunks past 32 or 16),
# head dims #7 lacks, pages outside 16-128 and not powers of two, fp32
# pools at 64 and 128 (with row chunks past 8), a query of another type
# against 16-bit and fp32 pools
_TMA_CASES = (
    [("fp16", None, g, d, ps) for g in (1, 2, 4, 8) for d in (64, 128)
     for ps in (16, 64)]
    + [(t, None, g, d, 64) for t in ("bf16", "fp16") for g in (16, 32, 48)
       for d in (64, 128)]
    + [(t, None, 4, d, 64) for t in ("bf16", "fp16") for d in (80, 96, 256)]
    + [(t, None, 2, 128, ps) for t in ("bf16", "fp16")
       for ps in (8, 24, 48, 256)]
    + [("fp32", None, g, d, ps) for g in (1, 4, 12) for d in (64, 128)
       for ps in (8, 64)]
    + [(t, "fp32", g, d, 64) for t in ("bf16", "fp16")
       for g, d in ((4, 128), (16, 64))]
    + [("fp16", "bf16", 4, 128, 64), ("bf16", "fp16", 2, 80, 24),
       ("fp32", "bf16", 4, 128, 64)])


@pytest.mark.parametrize("pool,query,group,d,ps", _TMA_CASES)
def test_wide_paged_tma_modes_match_plain(cuda, pool, query, group, d, ps):
    """Every shape class #7w's TMA modes take (``kv_decode.cuh``'s wide
    operand modes), sent there by the host predicate, against the plain
    version."""
    _assert_wide_paged(_wide_mode_case(cuda, pool, group, d, ps, query),
                       True)


@pytest.mark.parametrize("pool,group,d,ps", [
    ("bf16", 4, 100, 64), ("fp16", 2, 36, 16), ("fp32", 2, 256, 64),
    ("fp32", 1, 98, 64), ("bf16", 4, 128, 20), ("fp16", 1, 64, 12)])
def test_wide_paged_rows_tma_cannot_box_stay_on_the_cuda_cores(
        cuda, pool, group, d, ps):
    """16-bit rows with d % 8 != 0, fp32 rows past head dim 128 or with d
    % 4 != 0, pages that are not a multiple of 8 rows: the host predicate
    keeps them on #7w's CUDA-core kernel, which holds the plain version."""
    _assert_wide_paged(_wide_mode_case(cuda, pool, group, d, ps), False)


def test_wide_paged_unaligned_pool_stays_on_the_cuda_cores(cuda):
    """A pool whose base is not 16-byte aligned (a view 8 bytes into its
    buffer) cannot be a TMA box's source: the CUDA-core kernel takes it."""
    q, kp, vp, table, lens = _wide_mode_case(cuda, "bf16", 16, 64, 64)
    flat = torch.empty(kp.numel() + 4, dtype=kp.dtype, device=cuda)
    kc = flat[4:].view(kp.shape)
    kc.copy_(kp)
    vc = vp.contiguous()
    assert kc.data_ptr() % 16 == 8 and vc.data_ptr() % 16 == 0
    _assert_wide_paged((q, kc, vc, table, lens), False)


def _instance_runs(cuda):
    """#7's bf16 instance (group 4, head dim 128, page 64, lengths across
    its splits) and the dense decode's (``DENSE``: a strided cache layer,
    group 4, head dim 128) on seeded inputs."""
    lengths = [0, 1, 63, 64, 65, 700, 1023, 2048, 4096, 4100]
    paged = pa.paged_decode_attention(
        *_paged_case(cuda, lengths, 4, 128, 64, 64, kvh=8, seed=37))
    b, kvh, s_cache, d = len(DENSE_LENGTHS), 2, 8192, 128
    ck = _randn((b, 2, kvh, s_cache, d), 123, cuda)
    cv = _randn((b, 2, kvh, s_cache, d), 124, cuda)
    q = _randn((b, kvh * 4, 1, d), 125, cuda)
    lens = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=cuda)
    dense = attn.decode_attention(q, ck[:, 1], cv[:, 1], lens,
                                  use_kernel=True)
    return {"paged": paged, "dense": dense}


def _digest(t) -> str:
    import hashlib
    raw = t.detach().contiguous().view(torch.int16).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


#: sha256 (first 16 hex digits) of :func:`_instance_runs`' outputs from
#: the kernel library as it was before the wide modes joined the
#: template, recorded on an H100 80GB HBM3
_INSTANCE_DIGESTS = {"paged": "c1f353d06d4878e7",
                     "dense": "aa8241c85fe98da8"}


def test_paged_instance_bits_match_the_recorded_run(cuda):
    """The wide modes joined #7's template under ``if constexpr``: #7's
    bf16 instance and the dense decode's give the bits they gave
    before."""
    got = {k: _digest(v) for k, v in _instance_runs(cuda).items()}
    assert got == _INSTANCE_DIGESTS


@pytest.mark.parametrize("dt", ["fp32", "fp16"])
@pytest.mark.parametrize("group,d", [(1, 64), (3, 80)])
def test_decode_attention_wide_branch(cuda, dt, group, d):
    """A dense fp32 or fp16 cache past the crossover (and a group and head
    dim the decode kernel lacks) take the JAX branch onto #3w: a strided
    layer view, lengths 0 and past the cache."""
    dtype = _WIDE_TYPES[dt]
    b, kvh, s = 3, 2, 300
    cache = _randn((b, 2, kvh, s, d), 160, cuda, dtype)
    k, v = cache[:, 0], cache[:, 1]
    q = _randn((b, kvh * group, d), 161, cuda, dtype)
    lens = torch.tensor([0, 17, 400], dtype=torch.int32, device=cuda)
    before = _build.launch_counts()["flash_attention_wide"]
    got = attn.decode_attention(q, k, v, lens, use_kernel=True)
    assert _build.launch_counts()["flash_attention_wide"] == before + 1
    qg = q.reshape(b, kvh, group, d)
    ref = attn._decode_reference(qg, k, v, lens, d ** -0.5).reshape(
        b, kvh * group, d)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    assert _slot_errors(got, ref).max().item() <= tol
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("params_dtype,cache_dtype,ps", [
    (torch.float32, torch.float32, 64), (torch.bfloat16, torch.bfloat16, 8),
    (torch.bfloat16, torch.float16, 64)])
def test_wide_engine_builds_and_decodes(cuda, params_dtype, cache_dtype, ps):
    """An fp32 engine (fp32 weights and pool), a page-8 bf16 engine and a
    bf16 model over an fp16 pool: each builds, serves two prompts and
    decodes on #7w (no other paged kernel), prefill on the flash route
    of its weights' type."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, num_layers=2,
                      num_attention_heads=4, num_kv_heads=2,
                      ffn_hidden_size=512, max_seq_length=256)
    params = _llama_tree(cfg, cuda, params_dtype)
    engine = InferenceEngine("llama", cfg, params, slots=2, max_seq=256,
                             page_size=ps, cache_dtype=cache_dtype,
                             device=cuda, decode_fusion="0")
    _build.reset_launch_counts()
    outs = engine.generate([[1, 2, 3, 4, 5], list(range(7, 70))],
                           max_new_tokens=6)
    counts = _build.launch_counts()
    assert [len(o) for o in outs] == [6, 6]
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert counts["paged_attention_wide"] > 0
    assert counts["paged_attention"] == 0
    prefill = "flash_attention_wide" if params_dtype == torch.float32 \
        else "flash_attention"
    assert counts[prefill] > 0


# -- the verify slab on the paged decode kernels ----------------------------
#
# paged_slab_attention folds the slab into slots * S virtual slots of a
# q_len-1 decode and makes one call of the paged route: #7 for a bf16
# pool at its instance shapes, #7w for the rest.  Held per (slot, row)
# against the kernel's plain version on the folded operands (2^-6 of
# each row's own max for 16-bit, 2e-5 for fp32) and against the plain
# slab function, the JAX package's (the window gathered, p normalised in
# base e before it is rounded: the two plain versions alone differ by up
# to 2^-7 of a row's max at bf16, so 2^-5 there).

def _slab_pool_case(cuda, dtype, group, d, ps, mpps, lengths, kvh,
                    sq=5, seed=180):
    """Only the live pages (and a trash page) of a two-layer pool, each
    slot's pages (with the slab's rows: lengths + S) in a random order,
    layer 1's strided view; q ``[slots, h, S, d]``."""
    win = mpps * ps
    need = [min(-(-(n + sq) // ps), mpps) for n in lengths]
    n_pages = sum(need)
    pool_k = _randn((n_pages + 1, 2, kvh, ps, d), seed, cuda, dtype)
    pool_v = _randn((n_pages + 1, 2, kvh, ps, d), seed + 1, cuda, dtype)
    perm = np.random.RandomState(seed + 2).permutation(n_pages)
    table = np.full((len(lengths), mpps), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(need):
        table[s, :n] = perm[cursor:cursor + n]
        cursor += n
    assert max(lengths) <= win
    q = _randn((len(lengths), kvh * group, sq, d), seed + 3, cuda, dtype)
    return (q, pool_k[:, 1], pool_v[:, 1], torch.from_numpy(table).to(cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda))


def _rows(t):
    """``[slots, h, S, d]`` as ``[slots * S, h, d]``: one row a slab row."""
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


# (pool type, group, head dim, page, window pages, kernel): Llama-3-8B's
# verify (group 4, d 128, page 64) on #7, GPT-3 1.3B's fp32 pool (group 1)
# on #7w, a bf16 group #7 lacks on #7w, an fp16 pool on #7w
_SLAB_CASES = [(torch.bfloat16, 4, 128, 64, 64, "paged_attention"),
               (torch.bfloat16, 1, 64, 16, 40, "paged_attention"),
               (torch.float32, 1, 128, 64, 32, "paged_attention_wide"),
               (torch.bfloat16, 16, 64, 64, 16, "paged_attention_wide"),
               (torch.float16, 4, 128, 32, 20, "paged_attention_wide")]


@pytest.mark.parametrize("dtype,group,d,ps,mpps,kernel", _SLAB_CASES)
def test_paged_slab_folds_onto_the_paged_kernels(cuda, dtype, group, d, ps,
                                                 mpps, kernel):
    """One launch of the route's kernel a call and none of the other;
    lengths 0, on a page edge, mid-window, within S rows of the window's
    end (rows past it emit 0) and at it; the same bits from a second
    call."""
    win = mpps * ps
    lengths = [0, ps, 700 % win, win - 3, win - 1, win]
    q, kp, vp, table, lens = _slab_pool_case(cuda, dtype, group, d, ps,
                                             mpps, lengths, kvh=2)
    other = ({"paged_attention", "paged_attention_wide"} - {kernel}).pop()
    before = _build.launch_counts()
    got = pa.paged_slab_attention(q, kp, vp, table, lens)
    after = _build.launch_counts()
    assert after[kernel] == before[kernel] + 1
    assert after[other] == before[other]
    again = pa.paged_slab_attention(q, kp, vp, table, lens)
    q3, fold_table, live = pa._slab_fold(q, table, lens, win)
    own = pa.paged_decode_reference(q3, kp, vp, fold_table, live, d ** -0.5)
    ref = pa.paged_slab_reference(q, kp, vp, table, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    fp32 = dtype == torch.float32
    assert _slot_errors(_rows(got), own).max().item() <= (
        2e-5 if fp32 else 2.0 ** -6)
    assert _slot_errors(_rows(got), _rows(ref)).max().item() <= (
        2e-5 if fp32 else 2.0 ** -5)
    assert torch.equal(got, again)
    for s, n in enumerate(lengths):
        past = [r for r in range(q.shape[2]) if n + r >= win]
        assert bool((got[s, :, past] == 0).all())


def test_paged_slab_refuses_more_virtual_slots_than_the_grid_takes(cuda):
    q, kp, vp, table, lens = _slab_pool_case(
        cuda, torch.bfloat16, 1, 64, 16, 2, [1] * 13108, kvh=1, sq=5)
    with pytest.raises(ValueError, match="65535"):
        pa.paged_slab_attention(q, kp, vp, table, lens)


def _diverges_undecided(engine, prompt, got, want, margin=0.5):
    """Whether ``got`` equals ``want``, or first differs from it at a
    token whose full-forward top-2 logits lie within ``margin`` (bf16
    matmuls of another batch shape round differently: a near tie may
    fall either way, and the streams part there)."""
    from apex_tpu_torch.inference import models
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             len(want))
    if n == len(want):
        return True
    seq = torch.tensor([prompt + want[:n]], device=engine.device)
    with torch.no_grad():
        logits = models.prefill_forward(engine.kind, engine.cfg,
                                        engine.params, seq)[0][-1, 0]
    top2 = logits.float().topk(2).values
    return float(top2[0] - top2[1]) <= margin


def test_spec_engine_verifies_on_the_paged_kernel(cuda):
    """A bf16 LLaMA engine with spec_k 3 serves the plain greedy stream
    (up to a near tie) and each verify step launches #7 once a layer (no
    decode step runs)."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(vocab_size=256, hidden_size=512, num_layers=2,
                      num_attention_heads=4, num_kv_heads=1,
                      ffn_hidden_size=512, max_seq_length=256)
    params = _llama_tree(cfg, cuda)
    prompts = [[1, 2, 3, 4, 5], list(range(7, 70)), [9] * 30]
    outs = {}
    for spec in (0, 3):
        engine = InferenceEngine("llama", cfg, params, slots=4, max_seq=256,
                                 page_size=64, device=cuda, spec_k=spec)
        reg = obs.reset_global_registry()
        _build.reset_launch_counts()
        outs[spec] = engine.generate(prompts, max_new_tokens=12)
        counts = _build.launch_counts()
        if spec:
            steps = int(reg.declared("infer_verify_dispatch_total").total())
            assert steps > 0
            assert int(reg.declared("infer_decode_dispatch_total")
                       .total()) == 0
            assert counts["paged_attention"] == cfg.num_layers * steps
            assert counts["paged_attention_wide"] == 0
    for p, got, want in zip(prompts, outs[3], outs[0]):
        assert len(got) == len(want) == 12 and got[0] == want[0]
        assert _diverges_undecided(engine, p, got, want)


# -- F4: bf16 views the instances cannot read go to the kernels that can ----

def test_misaligned_bf16_pool_at_the_instance_shape_runs_on_7w(cuda):
    """#7's shape (group 4, head dim 128, page 64), its pool 8 bytes into
    its buffer, and another with a page stride of a multiple of 4 but not
    8: the route sends both to #7w's CUDA-core mode, which holds the
    plain version."""
    lengths = [0, 1, 64, 700, 2000, 4096]
    q, kp, vp, table, lens = _paged_case(cuda, lengths, 4, 128, 64, 64,
                                         kvh=8, seed=190)
    flat = torch.empty(kp.numel() + 4, dtype=kp.dtype, device=cuda)
    kc = flat[4:].view(kp.shape)
    kc.copy_(kp)
    vc = vp.contiguous()
    assert kc.data_ptr() % 16 == 8
    assert pa._paged_route(q.dtype, kc.dtype, 4, 128, 64, kc.stride(0),
                           (kc.data_ptr(), vc.data_ptr())) \
        == "paged_attention_wide"
    _assert_wide_paged((q, kc, vc, table, lens), False)
    inner = kp[0].numel()
    buf = torch.empty(kp.shape[0], inner + 4, dtype=kp.dtype, device=cuda)
    ks = buf.as_strided(kp.shape, (inner + 4,) + kp.stride()[1:])
    ks.copy_(kp)
    bv = torch.empty_like(buf)
    vs = bv.as_strided(vp.shape, (inner + 4,) + vp.stride()[1:])
    vs.copy_(vp)
    assert ks.stride(0) % 8 == 4
    _assert_wide_paged((q, ks, vs, table, lens), False)


@pytest.mark.parametrize("layout", ["unaligned", "odd-slot-stride"])
def test_strided_bf16_cache_at_the_decode_shape_runs_on_a_copy(cuda, layout):
    """The dense decode kernel's shape (group 4, head dim 128) on a bf16
    cache it cannot read in place: one launch of the decode kernel on a
    contiguous copy, the plain version held per row."""
    b, kvh, s_cache, d = len(DENSE_LENGTHS), 2, 8192, 128
    k0 = _randn((b, kvh, s_cache, d), 191, cuda)
    v0 = _randn((b, kvh, s_cache, d), 192, cuda)
    q = _randn((b, kvh * 4, 1, d), 193, cuda)
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=cuda)
    if layout == "unaligned":
        views = []
        for t in (k0, v0):
            flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=cuda)
            views.append(flat[4:].view(t.shape))
            views[-1].copy_(t)
    else:
        views = []
        for t in (k0, v0):
            inner = kvh * s_cache * d
            buf = torch.empty(b, inner + 4, dtype=t.dtype, device=cuda)
            views.append(buf.as_strided(t.shape, (inner + 4,)
                                        + t.stride()[1:]))
            views[-1].copy_(t)
    k, v = views
    assert not attn._decode_in_place(k, v)
    counts = _build.launch_counts()
    got = attn.decode_attention(q, k, v, lengths, use_kernel=True)
    after = _build.launch_counts()
    assert after["flash_attention_masked"] == \
        counts["flash_attention_masked"] + 1
    assert after["flash_attention"] == counts["flash_attention"]
    ref = attn._decode_reference(q.reshape(b, kvh, 4, d), k0, v0, lengths,
                                 d ** -0.5)
    torch.cuda.synchronize()
    got = got.reshape(b, kvh, 4, d)
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert bool((got[0] == 0).all())


# -- tensor-parallel serving: the fused blocks' rank-partial instance (V6) --

def _partial_case(cuda, kind, hidden, heads, kvh, d, lengths, ps=64,
                  mpps=32, seed=0):
    """One rank's shard of a decode layer in the fused layout (``wq
    [hidden, heads * d]``, ``wo [heads * d, hidden]``: ``heads * d`` is
    hidden / tp, not hidden), bf16 matrices (GPT: fp32 norm affines and
    biases, its ``bo`` whole), over one layer of a strided 2-layer pool."""
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)
    slots = len(lengths)

    def lin(i, o, s):
        return _randn((i, o), seed + s, cuda) * i ** -0.5

    def vec(n, s, base=0.0):
        return base + 0.1 * _randn((1, n), seed + s, cuda, torch.float32)

    blk = {"wq": lin(hidden, heads * d, 1), "wk": lin(hidden, kvh * d, 2),
           "wv": lin(hidden, kvh * d, 3), "wo": lin(heads * d, hidden, 4)}
    if kind == "gpt":
        blk.update(ln1_w=vec(hidden, 5, 1.0), ln1_b=vec(hidden, 6),
                   bq=vec(heads * d, 7), bk=vec(kvh * d, 8),
                   bv=vec(kvh * d, 9), bo=vec(hidden, 10))
    else:
        blk["ln1_w"] = 1 + 0.1 * _randn((1, hidden), seed + 5, cuda)
    n_pages = slots * mpps
    pool_k = _randn((n_pages + 1, 2, kvh, ps, d), seed + 11, cuda)
    pool_v = _randn((n_pages + 1, 2, kvh, ps, d), seed + 12, cuda)
    perm = np.random.RandomState(seed + 13).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s_, n in enumerate(lengths):
        need = min(-(-n // ps), mpps)
        table[s_, :need] = perm[cursor:cursor + need]
        cursor += need
    kw = dict(kind=kind, eps=1e-5)
    if kind == "llama":
        cos_t, sin_t = _rope_cos_sin(mpps * ps, d, 500000.0, device=cuda)
        pos = torch.clamp(torch.tensor(lengths, device=cuda),
                          max=mpps * ps - 1)
        kw.update(cos=cos_t.reshape(-1, d)[pos], sin=sin_t.reshape(-1, d)[pos])
    return (_randn((slots, hidden), seed + 14, cuda), blk, pool_k[:, 1],
            pool_v[:, 1], torch.from_numpy(table).to(cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda)), kw


#: one tp = 2 rank's shard: Llama-3-8B (16 of 32 heads over 4 of 8 kv
#: heads, wq [4096, 2048]) and GPT-3 1.3B (8 of 16 heads of 128, wq
#: [2048, 1024]); lengths across pages (64) and attention items (256)
PARTIAL_SHARDS = {"llama": dict(hidden=4096, heads=16, kvh=4, d=128),
                  "gpt": dict(hidden=2048, heads=8, kvh=8, d=128)}
PARTIAL_LENGTHS = [0, 1, 63, 64, 65, 700, 1500, 2048]


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_partial_block_kernel_matches_plain(cuda, kind):
    """The rank-partial instance at a tp = 2 shard: ``ctx @ wo`` alone
    (and the current token's k and v) against ``fused_block_reference(
    partial_out=True)``; one launch of its own counter and none of the
    whole-layer instance's."""
    args, kw = _partial_case(cuda, kind, lengths=PARTIAL_LENGTHS,
                             **PARTIAL_SHARDS[kind])
    name = "fused_block_decode_gpt" if kind == "gpt" else "fused_block_decode"
    counts = _build.launch_counts()
    got = pa.fused_block_decode(*args, fuse_mlp=False, partial_out=True,
                                **kw)
    after = _build.launch_counts()
    assert after[f"{name}_partial"] == counts[f"{name}_partial"] + 1
    assert after[name] == counts[name]
    ref = pa.fused_block_reference(*args, fuse_mlp=False, partial_out=True,
                                   **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


#: one tp = 4 rank's shard: Llama-3-8B (8 of 32 heads over 2 of 8 kv
#: heads, wq [4096, 1024]) and GPT-3 1.3B (4 of 16 heads of 128)
PARTIAL_SHARDS_TP4 = {"llama": dict(hidden=4096, heads=8, kvh=2, d=128),
                      "gpt": dict(hidden=2048, heads=4, kvh=4, d=128)}


def _partial_run(args, kw):
    return pa.fused_block_decode(*args, fuse_mlp=False, partial_out=True,
                                 **kw)


def _assert_partial_close(args, kw, got=None):
    got = _partial_run(args, kw) if got is None else got
    ref = pa.fused_block_reference(*args, fuse_mlp=False, partial_out=True,
                                   **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_partial_block_kernel_at_the_tp4_shards(cuda, kind):
    """The rank-partial instance at a tp = 4 shard (fewer heads, the
    same weights' widths): against its plain version."""
    args, kw = _partial_case(cuda, kind, lengths=PARTIAL_LENGTHS,
                             **PARTIAL_SHARDS_TP4[kind])
    _assert_partial_close(args, kw)


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_partial_block_kernel_repeats_bit_for_bit(cuda, kind):
    """Ten launches on the same inputs give the same bits: every sum runs
    in a fixed order (split-K chunks, splits, warps), whichever block
    finishes last."""
    args, kw = _partial_case(cuda, kind, lengths=PARTIAL_LENGTHS,
                             **PARTIAL_SHARDS[kind])
    first = [_digest(t) for t in _partial_run(args, kw)]
    for _ in range(9):
        assert [_digest(t) for t in _partial_run(args, kw)] == first


@pytest.mark.parametrize("kind", ["llama", "gpt"])
@pytest.mark.parametrize("lengths", [[5, 700, 64], [0, 1, 63, 64, 65, 255,
                                                    256, 257, 1000, 2048, 7,
                                                    300]])
def test_partial_block_kernel_slot_counts(cuda, kind, lengths):
    """3 slots (one pass of 8, five empty rows) and 12 (two passes over
    each weight tile, the second with 4)."""
    args, kw = _partial_case(cuda, kind, hidden=1024, heads=8,
                             kvh=2 if kind == "llama" else 8, d=128,
                             lengths=lengths)
    _assert_partial_close(args, kw)


@pytest.mark.parametrize("ps", [64, 16, 8, 24, 128, 12, 100])
@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_partial_block_kernel_edge_lengths_and_page_sizes(cuda, kind, ps):
    """Lengths on and across the edges of a page, a 64-token stage and a
    256-token run (0, 1, 63, 64, 65, 255, 256, 257), the window itself and
    past it (clamped to the window), at page sizes that a stage holds
    several of, one of, or part of, and at page sizes that are not a
    multiple of 8 rows (a box past the page reads zeros, masked)."""
    mpps = -(-600 // ps)
    window = mpps * ps
    lengths = [0, 1, 63, 64, 65, 255, 256, 257, window, window + 37]
    args, kw = _partial_case(cuda, kind, hidden=1024, heads=8,
                             kvh=2 if kind == "llama" else 8, d=128,
                             lengths=lengths, ps=ps, mpps=mpps)
    _assert_partial_close(args, kw)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_partial_block_kernel_groups_and_head_dims(cuda, group, d):
    """Every LLaMA instance (query groups 1, 2, 4, 8; head dims 64, 128)
    and the GPT instance at head dim 64, with bf16 and fp32 norm
    weights."""
    heads = 8
    args, kw = _partial_case(cuda, "llama", hidden=512, heads=heads,
                             kvh=heads // group, d=d,
                             lengths=[0, 1, 63, 64, 65, 300, 900, 2048],
                             seed=group)
    _assert_partial_close(args, kw)
    x, blk = args[0], args[1]
    blk32 = dict(blk, ln1_w=blk["ln1_w"].float())
    _assert_partial_close((x, blk32) + tuple(args[2:]), kw)
    if group == 1:
        gargs, gkw = _partial_case(cuda, "gpt", hidden=512, heads=heads,
                                   kvh=heads, d=d, lengths=[0, 1, 65, 300,
                                                            2048], seed=9)
        _assert_partial_close(gargs, gkw)


def test_partial_block_kernel_back_to_back_on_changing_inputs(cuda):
    """40 launches queued back to back (no sync between them) on changing
    inputs and lengths, each held against its plain version: the
    kernel's device counters must be back at zero after every launch."""
    args, kw = _partial_case(cuda, "llama", lengths=PARTIAL_LENGTHS,
                             **PARTIAL_SHARDS["llama"])
    x, blk, kp, vp, table, lengths = args
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    runs = []
    for i in range(40):
        xi = torch.randn(x.shape, generator=gen, device=cuda).to(x.dtype)
        li = torch.roll(lengths, i) if i % 2 else lengths.flip(0)
        a = (xi, blk, kp, vp, table, li)
        kwi = dict(kw, cos=torch.roll(kw["cos"], i, 0),
                   sin=torch.roll(kw["sin"], i, 0))
        runs.append((a, kwi, _partial_run(a, kwi)))
    torch.cuda.synchronize()
    for a, kwi, got in runs:
        _assert_partial_close(a, kwi, got)


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_partials_of_two_ranks_sum_to_the_attention_block(cuda, kind):
    """A whole layer (8 heads of 128 over 4 kv heads; GPT 8 over 8) split
    over two ranks: the two partials summed, plus x (and bo once), are
    the whole attention-only block's y within a few bf16 ulps (each
    partial rounds to bf16 once before the sum)."""
    hidden, heads, d = 1024, 8, 128
    kvh = heads if kind == "gpt" else 4
    (x, blk, kp, vp, table, lengths), kw = _partial_case(
        cuda, kind, hidden, heads, kvh, d, PARTIAL_LENGTHS, mpps=32, seed=40)
    whole = pa.fused_block_decode(x, blk, kp, vp, table, lengths,
                                  fuse_mlp=False, **kw)[0]
    from apex_tpu_torch.inference import models
    spec = models.fused_partition_specs([blk], 2)[0]
    total = x.float() + (blk["bo"] if kind == "gpt" else 0)
    for rank in range(2):
        shard = models.shard_tree(blk, spec, 2, rank)
        half = kvh // 2
        kr, vr = (t[:, rank * half:(rank + 1) * half] for t in (kp, vp))
        total = total + pa.fused_block_decode(
            x, shard, kr, vr, table, lengths, fuse_mlp=False,
            partial_out=True, **kw)[0].float()
    torch.cuda.synchronize()
    assert _maxdiff(total, whole) <= 2.0 ** -5 * whole.float().abs().max()
    assert _rel_l2(total, whole) <= 1e-2


def _fused_instance_runs(cuda):
    """#8 (group 4, head dim 128) and #8g (head dim 128) whole layers,
    with the MLP and without, on seeded inputs."""
    out = {}
    for fuse_mlp in (True, False):
        pa_, args, kw = _fused_case(cuda, 4, 128, [0, 1, 15, 16, 320, 7, 64,
                                                   100])
        y, kt, vt = pa_.fused_block_decode(*args, fuse_mlp=fuse_mlp, **kw)
        gargs, gkw = _gpt_fused_case(cuda, 128, [0, 1, 15, 16, 255, 256,
                                                 300, 384])
        gy, gkt, gvt = pa.fused_block_decode(*gargs, fuse_mlp=fuse_mlp,
                                             **gkw)
        tag = "mlp" if fuse_mlp else "attn"
        out.update({f"llama {tag} y": y, f"llama {tag} k": kt,
                    f"llama {tag} v": vt, f"gpt {tag} y": gy,
                    f"gpt {tag} k": gkt, f"gpt {tag} v": gvt})
    return out


#: sha256 (first 16 hex digits) of :func:`_fused_instance_runs`' outputs
#: from the kernel library as it was before the rank-partial entries
#: joined it, recorded on an H100 80GB HBM3
_FUSED_DIGESTS = {
    "llama mlp y": "2924701b98894d0a", "llama mlp k": "db164ad27683db21",
    "llama mlp v": "d7bb197bb94ca395", "gpt mlp y": "5b72da56e55683ee",
    "gpt mlp k": "95d1ed66397dc056", "gpt mlp v": "5ae3c63b1c84bbdb",
    "llama attn y": "cacd4781c3fd9a1e", "llama attn k": "db164ad27683db21",
    "llama attn v": "d7bb197bb94ca395", "gpt attn y": "b081714c887e42f0",
    "gpt attn k": "95d1ed66397dc056", "gpt attn v": "5ae3c63b1c84bbdb"}


def test_fused_instance_bits_match_the_recorded_run(cuda):
    """The rank-partial flag joined #8's and #8g's phase 5: both whole-layer
    instances, with and without the MLP, give the bits they gave
    before."""
    got = {k: _digest(v) for k, v in _fused_instance_runs(cuda).items()}
    assert got == _FUSED_DIGESTS


def _tp_rank(rank, tp, store, cfg_kw, tree, prompts, out):
    """One rank of a gloo-served tp engine on cuda:0: its streams and the
    launches of its unfused and its fused serve."""
    import datetime
    import torch.distributed as dist
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, tp),
                            rank=rank, world_size=tp,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = {}
        for fusion in ("0", "1"):
            engine = InferenceEngine(
                "llama", LlamaConfig(**cfg_kw), tree, slots=4, max_seq=256,
                page_size=64, device="cuda", tp=tp, decode_fusion=fusion)
            _build.reset_launch_counts()
            outs = engine.generate(prompts, max_new_tokens=12)
            torch.cuda.synchronize()
            res[fusion] = (outs, _build.launch_counts())
    finally:
        dist.destroy_process_group()
    torch.save(res, f"{out}.{rank}")


def test_tp_engine_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """A small LLaMA-GQA (8 heads of 128 over 2 kv heads: a rank takes 4
    over 1) served by two ranks on cuda:0 over gloo, unfused (#7 on each
    rank's pool shard) and fused (V6): every rank the same streams, equal
    to the single-card engine's up to a near tie, and the rank's kernels
    launched."""
    import torch.multiprocessing as mp
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg_kw = dict(vocab_size=256, hidden_size=1024, num_layers=2,
                  num_attention_heads=8, num_kv_heads=2, ffn_hidden_size=512,
                  max_seq_length=256)
    cfg = LlamaConfig(**cfg_kw)
    tree = _llama_tree(cfg, "cpu")
    prompts = [[1, 2, 3, 4, 5], list(range(7, 70)), [9] * 30]
    one = InferenceEngine("llama", cfg, tree, slots=4, max_seq=256,
                          page_size=64, device=cuda)
    want = one.generate(prompts, max_new_tokens=12)
    mp.start_processes(_tp_rank, nprocs=2, start_method="spawn",
                       args=(2, str(tmp_path / "store"), cfg_kw, tree,
                             prompts, str(tmp_path / "out")))
    ranks = [torch.load(f"{tmp_path / 'out'}.{r}", weights_only=False)
             for r in range(2)]
    for fusion, kernel in (("0", "paged_attention"),
                           ("1", "fused_block_decode_partial")):
        outs, launches = ranks[0][fusion]
        assert ranks[1][fusion][0] == outs
        assert launches[kernel] > 0 and launches["flash_attention"] > 0
        assert ranks[1][fusion][1] == launches
        other = {"paged_attention", "fused_block_decode_partial",
                 "fused_block_decode"} - {kernel}
        assert not any(launches[k] for k in other), launches
        for p, got, w in zip(prompts, outs, want):
            assert len(got) == 12 and got[0] == w[0]
            assert _diverges_undecided(one, p, got, w)


# -- the host page tier on the card ------------------------------------------
#
# The swaps are copies, not kernels: pages gathered into a fresh slab and
# copied into pinned host buffers, non_blocking, in stream order; swap-in
# staged through pinned memory.  What the card adds is the asynchrony:
# a deferred swap-out must still read the bits from before a later
# in-place write, and every pool type must come back bit for bit.

def _tier_engine(cuda, cache_dtype=torch.bfloat16, **kw):
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(vocab_size=256, hidden_size=512, num_layers=4,
                      num_attention_heads=8, num_kv_heads=8,
                      ffn_hidden_size=512, max_seq_length=512)
    return InferenceEngine("llama", cfg, _llama_tree(cfg, cuda), slots=4,
                           max_seq=512, page_size=64, num_pages=24,
                           cache_dtype=cache_dtype, device=cuda,
                           host_tier_bytes=1 << 30, **kw)


def _bits_of(t):
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


def _fill_pool(cache, seed):
    gen = torch.Generator(device=cache.device)
    gen.manual_seed(seed)
    for pool in (cache.k, cache.v):
        pool.copy_(torch.randn(pool.shape, generator=gen,
                               device=cache.device))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n", [1, 4, 5, 11])
def test_swap_round_trip_bit_for_bit(cuda, dtype, n):
    """Pages out to the host and back into other pages at batch 4 (page
    counts on and off the batch): the bits come back; a bf16 pool's host
    slabs are its uint16 bits; ceil(n / 4) dispatches each way."""
    eng = _tier_engine(cuda, dtype, swap_batch_pages=4)
    cache = eng.init_cache()
    _fill_pool(cache, 200 + n)
    src = list(range(n))
    dst = list(range(23, 23 - n, -1))          # disjoint from src
    assert not set(src) & set(dst)
    eng._refresh_dispatch_counters()
    o0 = int(eng._swap_out_dispatches.total())
    i0 = int(eng._swap_in_dispatches.total())
    k, v = eng.swap_out_pages(cache, src)
    want = {torch.bfloat16: np.uint16, torch.float16: np.float16,
            torch.float32: np.float32}[dtype]
    assert k.dtype == want and k.shape == (n,) + tuple(cache.k.shape[1:])
    eng.swap_in_pages(cache, dst, k, v)
    torch.cuda.synchronize()
    idx_s = torch.tensor(src, device=cuda)
    idx_d = torch.tensor(dst, device=cuda)
    for pool in (cache.k, cache.v):
        assert torch.equal(_bits_of(pool[idx_d]), _bits_of(pool[idx_s]))
    assert int(eng._swap_out_dispatches.total()) - o0 == -(-n // 4)
    assert int(eng._swap_in_dispatches.total()) - i0 == -(-n // 4)


def test_deferred_swap_out_survives_an_overwrite_before_resolve(cuda):
    """A deferred swap-out, then the same pages overwritten in place
    (zeroed, then a prefill into them as into pages acquired again)
    before ``resolve()``: it resolves to the bits before the overwrite,
    and repeats them on a second call."""
    eng = _tier_engine(cuda, swap_batch_pages=2)
    cache = eng.init_cache()
    _fill_pool(cache, 210)
    ids = [3, 4, 5, 6, 7]
    idx = torch.tensor(ids, device=cuda)
    before_k, before_v = cache.k[idx].clone(), cache.v[idx].clone()
    pending = eng.swap_out_pages(cache, ids, defer=True)
    cache.k[idx] = 0
    cache.v[idx] = 0
    cache, _, _ = eng.prefill(cache, [t % 256 for t in range(1, 300)], 0,
                              pages=ids)
    assert not pending.done
    k, v = pending.resolve()
    assert pending.done and pending.resolve()[0] is k
    assert np.array_equal(k, _bits_of(before_k).cpu().numpy().view(
        np.uint16))
    assert np.array_equal(v, _bits_of(before_v).cpu().numpy().view(
        np.uint16))
    assert not torch.equal(cache.k[idx], before_k)


def test_swap_of_a_tp_shard_view(cuda):
    """A rank's pool as a view of half the kv heads of a larger pool
    (not contiguous): swap-out reads that shard's rows, swap-in writes
    them and leaves the other heads as they were."""
    from apex_tpu_torch.inference import kv_cache
    eng = _tier_engine(cuda, swap_batch_pages=3)
    full = kv_cache.init_paged_cache(24, 4, 16, 64, 64, slots=4,
                                     max_pages_per_slot=8, device=cuda)
    _fill_pool(full, 220)
    shard = kv_cache.PagedKVCache(
        k=full.k[:, :, 8:], v=full.v[:, :, 8:], page_table=full.page_table,
        lengths=full.lengths, capacity=full.capacity)
    other = full.k[:, :, :8].clone()
    k, v = eng.swap_out_pages(shard, [0, 1, 2, 9])
    want = full.k[[0, 1, 2, 9]][:, :, 8:].contiguous()
    assert np.array_equal(k, _bits_of(want).cpu().numpy().view(np.uint16))
    eng.swap_in_pages(shard, [20, 21, 22, 23], k, v)
    torch.cuda.synchronize()
    assert torch.equal(_bits_of(full.k[20:24, :, 8:]), _bits_of(want))
    assert torch.equal(_bits_of(full.k[:, :, :8]), _bits_of(other))


def test_host_tier_engine_serves_a_hit_after_eviction(cuda):
    """The scheduler on the card: a prompt's prefix pages evicted to the
    host tier, the same prompt again swaps them in (a host hit, #3 and #7
    launched) and serves the cold run's stream up to a near tie."""
    from apex_tpu_torch.inference import SlotScheduler
    from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
    eng = _tier_engine(cuda)
    prompt = list(range(5, 200)) + [7]
    cold = SlotScheduler(eng, telemetry=ServeTelemetry(MetricsRegistry()),
                         prefix_cache=False)
    u = cold.submit(prompt, max_new_tokens=12)
    want = cold.run()[u]
    tel = ServeTelemetry(MetricsRegistry())
    sched = SlotScheduler(eng, telemetry=tel)
    sched.submit(prompt, max_new_tokens=12)
    sched.run()
    assert sched.prefix.evict_lru(eng.num_pages) > 0
    assert sched.prefix.host_pages == 3
    _build.reset_launch_counts()
    u = sched.submit(prompt, max_new_tokens=12)
    got = sched.run()[u]
    counts = _build.launch_counts()
    assert int(tel.swap_in_pages.total()) == 3
    assert int(tel.prefix_host_hits.total()) == 1
    assert counts["flash_attention"] == 0          # the suffix is warm
    assert counts["paged_attention"] > 0
    assert len(got) == 12 and got[0] == want[0]
    assert _diverges_undecided(eng, prompt, got, want)


# -- the pipeline schedules on the card ---------------------------------------
#
# Two ranks on cuda:0 over gloo (NCCL takes one card a rank): the pipe
# ring's hops are staged through host tensors, and what arrives must be
# the bits sent.  A 1F1B step's grads are the rank's share of the same
# step without pipelining within TOL_PP_GRAD relative L2: both run the
# same kernels on the same operands, and only #4's dq, added by bulk
# reductions in any order, can part them.

TOL_PP_GRAD = 1e-2
PP_CFG = dict(vocab_size=256, hidden_size=512, num_layers=2,
              num_attention_heads=8, num_kv_heads=2, ffn_hidden_size=1024,
              max_seq_length=256, params_dtype=torch.bfloat16)


def _pp_stage(p, x, mb):
    for layer in p["layers"].values():
        flat = {".".join(k): v for k, v in _pp_paths(layer)}
        x = torch.func.functional_call(_PP_BLOCKS[0], flat, (x,))
    return x


_PP_BLOCKS: list = []


def _pp_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _pp_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _pp_loss(y, mb, p):
    from apex_tpu_torch.normalization import fused_rms_norm
    h = fused_rms_norm(y, (PP_CFG["hidden_size"],),
                       p["final_norm"]["weight"], 1e-5)
    logits = torch.nn.functional.linear(h, p["lm_head"]["weight"]).float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), mb["labels"].T.reshape(-1))


def _pp_rank(rank, store, tree, batch, out):
    """One pipe rank on cuda:0 over gloo: the staged hops both ways, the
    no-pipelining run of both layers, and one 1F1B step of its layer."""
    import datetime
    import torch.distributed as dist
    from apex_tpu_torch.parallel import _comm
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer import pipeline_parallel as tpp
    from apex_tpu_torch.transformer.pipeline_parallel import \
        p2p_communication as p2p
    from apex_tpu_torch.transformer.testing import LlamaConfig
    from apex_tpu_torch.transformer.testing.standalone_llama import \
        LlamaBlock
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        ps.initialize_model_parallel(1, 2)
        dev = torch.device("cuda", 0)
        res = {}
        sent = [_randn((256, 2, 512), 90 + r, dev) for r in range(2)]
        res["staged"] = _comm.hop_staged(sent[rank],
                                         ps.get_pipeline_model_parallel_group())
        fwd = p2p.send_forward_recv_forward(sent[rank])
        bwd = p2p.send_backward_recv_backward(sent[rank] * 2)
        pair = p2p.send_forward_recv_backward(sent[rank], sent[rank] * 4)
        other = sent[1 - rank]
        res["hops"] = [torch.equal(fwd, other), torch.equal(bwd, other * 2),
                       torch.equal(pair[0], other),
                       torch.equal(pair[1], other * 4)]
        t = _to_dev(tree, dev)
        _PP_BLOCKS[:] = [LlamaBlock(LlamaConfig(**PP_CFG), device=dev)]
        mbs = {k: v.to(dev) for k, v in batch.items()}
        embed = t["embed_tokens"]["weight"]

        def input_fn(mb):
            return torch.nn.functional.embedding(mb["tokens"],
                                                 embed).transpose(0, 1)

        full = {"layers": {"layer_0": t["layer_0"], "layer_1": t["layer_1"]},
                "final_norm": t["final_norm"], "lm_head": t["lm_head"]}
        ref_loss, ref = tpp.forward_backward_no_pipelining(
            _pp_stage, _pp_loss, full, mbs, num_microbatches=4,
            input_fn=input_fn)
        stage = {"layers": {f"layer_{rank}": t[f"layer_{rank}"]}}
        if rank == 1:
            stage.update(final_norm=t["final_norm"], lm_head=t["lm_head"])
        _build.reset_launch_counts()
        loss, grads = tpp.forward_backward_pipelining_without_interleaving(
            _pp_stage, _pp_loss, stage, mbs, num_microbatches=4,
            input_fn=input_fn)
        torch.cuda.synchronize()
        res["launches"] = _build.launch_counts()
        res["loss"] = (float(loss), float(ref_loss))
        rel = {}
        for path, g in _pp_paths(grads):
            want = ref
            for k in path:
                want = want[k]
            rel[".".join(path)] = float(
                torch.linalg.vector_norm((g - want).float())
                / torch.linalg.vector_norm(want.float()))
        res["rel"] = rel
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(res, f"{out}.{rank}")


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_pipeline_1f1b_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """A 2-layer bf16 LLaMA at pp = 2 on cuda:0 (a layer a rank; the last
    rank also the norm and head, trained by the 3-argument loss): the
    staged hop's payload arrives bit for bit in both directions and in
    the steady tick's pair; one 1F1B step's loss is the no-pipelining
    run's and each grad leaf within TOL_PP_GRAD relative L2 of it; the
    rank launched #1-#4 for its layer (and the last rank's final norm)."""
    import torch.multiprocessing as mp
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(**PP_CFG)
    tree = _llama_tree(cfg, "cpu")
    rng = np.random.RandomState(7)
    tok = rng.randint(0, PP_CFG["vocab_size"], (4, 2, 129))
    batch = {"tokens": torch.from_numpy(tok[..., :-1]),
             "labels": torch.from_numpy(tok[..., 1:])}
    mp.start_processes(_pp_rank, nprocs=2, start_method="spawn",
                       args=(str(tmp_path / "store"), tree, batch,
                             str(tmp_path / "out")))
    ranks = [torch.load(f"{tmp_path / 'out'}.{r}", weights_only=False)
             for r in range(2)]
    for rank, res in enumerate(ranks):
        assert res["staged"]
        assert res["hops"] == [True] * 4, res["hops"]
        loss, ref = res["loss"]
        assert abs(loss - ref) <= 1e-3 * abs(ref), res["loss"]
        assert res["rel"] and max(res["rel"].values()) <= TOL_PP_GRAD, \
            res["rel"]
        norms = 2 + (1 if rank == 1 else 0)
        want = {"layer_norm": 4 * norms, "layer_norm_bwd": 4 * norms,
                "flash_attention": 4, "flash_attention_bwd": 4}
        assert {k: res["launches"][k] for k in want} == want, res["launches"]
    assert ranks[0]["loss"][0] == ranks[1]["loss"][0]


# -- the fp32-output instances ring attention runs (#3, #3d, #4, #4d's) --
#
# On bf16 operands with out_dtype=torch.float32 the forward and the
# one-pass backward take instances that store their fp32 accumulators
# without a round to bf16.  Each is held against its plain version (the
# same tolerances as the bf16 instances, the backward also against the
# exact float64 gradient), and against its bf16 twin on the same
# operands: the twins compute the same accumulators, so the forward's out
# and lse and the backward's dk and dv round to the twin's bits exactly
# (dq is added by bulk reductions in any order: :func:`_dq_near_twin`).
# Ring attention's shard pairs are square; the dropout rows also take the
# seed operand's offsets of the ring's second step (rows 4096 on, keys
# from 0) and the converse.

_F32_FWD_CASES = [
    # d, rate, (row_off, col_off)
    (32, 0.0, (0, 0)), (64, 0.0, (0, 0)), (128, 0.0, (0, 0)),
    (64, 0.1, (0, 0)), (128, 0.1, (0, 0)), (128, 0.1, (4096, 0)),
    (64, 0.1, (0, 4096)),
]
_F32_SHAPES = [(100, 100, True), (256, 256, False), (300, 300, True),
               (256, 512, False)]


def _f32_operands(cuda, d, sq, sk, seed, bh=6):
    return tuple(_randn((bh, s, d), seed + i, cuda)
                 for i, s in enumerate((sq, sk, sk, sq)))


def _assert_f32_bwd_close(got, ref, exact):
    """fp32 grads against the plain version's fp32 grads: within 1e-2
    relative L2, and each element within 2^-6 |ref| + 2^-9 or no less
    accurate than the plain version against the exact gradient."""
    for g, r, x in zip(got, ref, exact):
        assert g.dtype == torch.float32 and r.dtype == torch.float32
        assert _rel_l2(g, r) <= 1e-2
        by_element = bool(((g - r).abs() <= 2.0 ** -6 * r.abs()
                           + 2.0 ** -9).all())
        ge, re = g.double() - x, r.double() - x
        by_exact = bool(ge.norm() <= 1.05 * re.norm()) and bool(
            ge.abs().max() <= 1.25 * re.abs().max())
        assert by_element or by_exact


def _dq_near_twin(a32, b16):
    """fp32 ``a32`` rounded to bf16 within one bf16 ulp of ``b16`` (of
    the larger magnitude), plus 2^-16 of ``b16``'s max where the sum
    cancels (the twins add dq's partials in different orders, and #4d's
    bf16 twin scales the sum, the fp32 instance each partial)."""
    a = a32.to(torch.bfloat16).float()
    b = b16.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    return bool(((a - b).abs() <= ulp + 2.0 ** -16 * b.abs().max()).all())


@pytest.mark.parametrize("d,rate,offs", _F32_FWD_CASES)
@pytest.mark.parametrize("sq,sk,causal", _F32_SHAPES)
def test_flash_f32out_forward_matches_plain_and_its_twin(cuda, d, rate, offs,
                                                         sq, sk, causal):
    q, k, v, _ = _f32_operands(cuda, d, sq, sk, 300)
    seed3 = attn._seed_operand(-98765, *offs, device=cuda) if rate else None
    name = "flash_attention_drop_f32out" if rate else "flash_attention_f32out"
    md = dict(rate=rate, seed3=seed3)
    before = _build.launch_counts()
    got, lse = attn._fwd(q, k, v, causal, d ** -0.5, **md,
                         out_dtype=torch.float32)
    after = _build.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {name: 1}
    twin, twin_lse = attn._fwd(q, k, v, causal, d ** -0.5, **md)
    ref, ref_lse = attn._fwd_reference(q, k, v, causal, d ** -0.5, **md,
                                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and ref.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 2e-2
    assert _row_errors(got, ref).max().item() <= 2.0 ** -6
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(got.to(torch.bfloat16), twin)
    assert torch.equal(lse, twin_lse)
    # the fp32 values are not bf16 values
    assert bool((got != got.to(torch.bfloat16).float()).any())


@pytest.mark.parametrize("d,rate,offs", _F32_FWD_CASES)
@pytest.mark.parametrize("sq,sk,causal", _F32_SHAPES)
def test_flash_f32out_backward_matches_plain_and_its_twin(
        cuda, d, rate, offs, sq, sk, causal):
    q, k, v, do = _f32_operands(cuda, d, sq, sk, 310)
    seed3 = attn._seed_operand(424243, *offs, device=cuda) if rate else None
    scale = d ** -0.5
    md = dict(rate=rate, seed3=seed3)
    # the ring's backward: the global out (q's type) and lse
    out, lse = attn._fwd(q, k, v, causal, scale, **md)
    name = ("flash_attention_bwd_drop_f32out" if rate
            else "flash_attention_bwd_f32out")
    before = _build.launch_counts()
    got = attn._bwd(q, k, v, out, lse, do, causal, scale, **md,
                    out_dtype=torch.float32)
    after = _build.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {name: 1}
    twin = attn._bwd(q, k, v, out, lse, do, causal, scale, **md)
    ref = attn._bwd_reference(q, k, v, out, lse, do, causal, scale, **md,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    _assert_f32_bwd_close(got, ref, _exact_grads_md(
        q, k, v, do, causal, scale, None, rate, seed3))
    assert _dq_near_twin(got[0], twin[0])
    assert torch.equal(got[1].to(torch.bfloat16), twin[1])
    assert torch.equal(got[2].to(torch.bfloat16), twin[2])


def test_flash_f32out_long_shard_pair(cuda):
    """The ring's shard pair at cp = 2 of an 8192-token sequence, 4 heads
    of GPT-3 1.3B's 16 (4096 queries against 4096 keys, d 128: the
    one-pass gate's 2 MiB exactly), the second step's full pair with
    dropout at rows 4096 on: the forward and backward against the plain
    versions (4 heads a slice) and their bf16 twins."""
    bh, s, d = 4, 4096, 128
    q, k, v, do = _f32_operands(cuda, d, s, s, 320, bh=bh)
    seed3 = attn._seed_operand(-2 ** 31 + 7, s, 0, device=cuda)
    scale = d ** -0.5
    md = dict(rate=0.1, seed3=seed3)
    out32, lse = attn._fwd(q, k, v, False, scale, **md,
                           out_dtype=torch.float32)
    twin, _ = attn._fwd(q, k, v, False, scale, **md)
    assert torch.equal(out32.to(torch.bfloat16), twin)
    ref, _ = attn._fwd_reference(q, k, v, False, scale, **md,
                                 out_dtype=torch.float32)
    assert _row_errors(out32, ref).max().item() <= 2.0 ** -6
    got = attn._bwd(q, k, v, twin, lse, do, False, scale, **md,
                    out_dtype=torch.float32)
    ref = attn._bwd_reference(q, k, v, twin, lse, do, False, scale, **md,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and _rel_l2(g, r) <= 1e-2


@pytest.mark.parametrize("d,rate,offs", _F32_FWD_CASES)
@pytest.mark.parametrize("sq,sk,causal", _F32_SHAPES)
def test_flash_f32out_split_pair_matches_plain_and_its_twin(
        cuda, monkeypatch, d, rate, offs, sq, sk, causal):
    """The split pair's fp32-output instances (5f, 6f; with dropout 5df,
    6df), the route past the one-pass gate (forced here with the gate at
    0): one launch of each, the grads against the plain version's fp32
    grads and the exact gradient, and against the bf16 twins on the same
    operands (the same accumulators: each rounds to its twin's bits)."""
    monkeypatch.setattr(attn, "_FUSED_BWD_MAX_BYTES", 0)
    q, k, v, do = _f32_operands(cuda, d, sq, sk, 350)
    seed3 = attn._seed_operand(-424243, *offs, device=cuda) if rate else None
    scale = d ** -0.5
    md = dict(rate=rate, seed3=seed3)
    out, lse = attn._fwd(q, k, v, causal, scale, **md)
    drop = "_drop" if rate else ""
    before = _build.launch_counts()
    got = attn._bwd(q, k, v, out, lse, do, causal, scale, **md,
                    out_dtype=torch.float32)
    after = _build.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {
        f"flash_attention_bwd_dq{drop}_f32out": 1,
        f"flash_attention_bwd_dkv{drop}_f32out": 1}
    twin = attn._bwd(q, k, v, out, lse, do, causal, scale, **md)
    ref = attn._bwd_reference(q, k, v, out, lse, do, causal, scale, **md,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    _assert_f32_bwd_close(got, ref, _exact_grads_md(
        q, k, v, do, causal, scale, None, rate, seed3))
    for g, t in zip(got, twin):
        assert torch.equal(g.to(torch.bfloat16), t)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_f32out_split_pair_repeats_bit_for_bit(cuda, monkeypatch,
                                                     rate):
    """Each output of the fp32 split pair written once: two runs give the
    same bits."""
    monkeypatch.setattr(attn, "_FUSED_BWD_MAX_BYTES", 0)
    q, k, v, do = _f32_operands(cuda, 128, 384, 384, 360)
    seed3 = attn._seed_operand(77, 384, 0, device=cuda) if rate else None
    md = dict(rate=rate, seed3=seed3)
    out, lse = attn._fwd(q, k, v, True, 128 ** -0.5, **md)
    runs = [attn._bwd(q, k, v, out, lse, do, True, 128 ** -0.5, **md,
                      out_dtype=torch.float32) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_f32out_routes_without_an_instance_raise(cuda, monkeypatch):
    """fp32 outputs where no instance is built (ROADMAP V10): a mask (the
    one-pass and the split backward's), fp16 operands on the wide
    family; and an out_dtype other than fp32 or the operands'.  Nothing
    rounds or runs the plain version.  The split pair without a mask
    has its instances: past the gate it launches them."""
    q, k, v, do = _f32_operands(cuda, 128, 256, 256, 330)
    scale = 128 ** -0.5
    out, lse = attn._fwd(q, k, v, True, scale)
    mask3 = torch.zeros(1, 256, 256, dtype=torch.bool, device=cuda)
    with pytest.raises(NotImplementedError, match="V10"):
        attn._fwd(q, k, v, True, scale, mask3=mask3, out_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="V10"):
        attn._bwd(q, k, v, out, lse, do, True, scale, mask3=mask3,
                  out_dtype=torch.float32)
    h16 = [t.half() for t in (q, k, v, do)]
    with pytest.raises(NotImplementedError, match="V10"):
        attn._fwd(*h16[:3], True, scale, out_dtype=torch.float32)
    monkeypatch.setattr(attn, "_FUSED_BWD_MAX_BYTES", 0)
    with pytest.raises(NotImplementedError, match="V10"):
        attn._bwd(q, k, v, out, lse, do, True, scale, mask3=mask3,
                  out_dtype=torch.float32)
    before = _build.launch_counts()
    grads = attn._bwd(q, k, v, out, lse, do, True, scale,
                      out_dtype=torch.float32)
    after = _build.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {
        "flash_attention_bwd_dq_f32out": 1,
        "flash_attention_bwd_dkv_f32out": 1}
    assert all(g.dtype == torch.float32 for g in grads)
    with pytest.raises(ValueError, match="out_dtype"):
        attn._fwd(q, k, v, True, scale, out_dtype=torch.float16)


def _flash_instance_runs(cuda):
    """The bf16 flash instances the fp32 parameter joined on seeded
    inputs: #3 and #3d's forward, #4 and #4d's dk and dv (their dq is
    added in any order), the split pair #5 and #6, and #5md and #6md
    with dropout, at causal [2, 3, 300, 128] (d 64 for #3 and #4 too)."""
    runs = {}
    for d in (64, 128):
        q, k, v, do = _f32_operands(cuda, d, 300, 300, 340 + d)
        scale = d ** -0.5
        seed3 = attn._seed_operand(777, device=cuda)
        for tag, md in (("", {}), ("d", dict(rate=0.1, seed3=seed3))):
            out, lse = attn._fwd(q, k, v, True, scale, **md)
            runs[f"#3{tag} d{d}"] = out
            runs[f"#3{tag} lse d{d}"] = lse
            _, dk, dv = attn._bwd(q, k, v, out, lse, do, True, scale, **md)
            runs[f"#4{tag} dk d{d}"] = dk
            runs[f"#4{tag} dv d{d}"] = dv
            delta = attn._delta(out, do)
            args = (q, k, v, lse, delta, do, True, scale)
            runs[f"#5{tag} d{d}"] = attn._dq_kernel(*args, **md)
            dk, dv = attn._dkv_kernel(*args, **md)
            runs[f"#6{tag} dk d{d}"] = dk
            runs[f"#6{tag} dv d{d}"] = dv
    return runs


#: sha256 (first 16 hex digits) of :func:`_flash_instance_runs`' outputs
#: from the kernel library as it was before the fp32-output parameter
#: joined the four flash templates, recorded on an H100 80GB HBM3
_FLASH_DIGESTS = {
    "#3 d64": "a79c8f343ae124b1",
    "#3 lse d64": "48d527eadd3557d3",
    "#4 dk d64": "1ada2ed0a9819cb8",
    "#4 dv d64": "2bd2e2944f33d9cf",
    "#5 d64": "f4f79cdd328e1acf",
    "#6 dk d64": "1ada2ed0a9819cb8",
    "#6 dv d64": "2bd2e2944f33d9cf",
    "#3d d64": "297bcce2c9cb06b3",
    "#3d lse d64": "263c9525bd5ac415",
    "#4d dk d64": "12518cbfbf3298fb",
    "#4d dv d64": "31326f084afb5206",
    "#5d d64": "fc56693aef461d53",
    "#6d dk d64": "12518cbfbf3298fb",
    "#6d dv d64": "31326f084afb5206",
    "#3 d128": "38d3f6e99a34d1b8",
    "#3 lse d128": "999335e8ee03cb90",
    "#4 dk d128": "3a61106a59a2b563",
    "#4 dv d128": "842a11f4928a7cf5",
    "#5 d128": "ba4f2d47ec115c35",
    "#6 dk d128": "3a61106a59a2b563",
    "#6 dv d128": "842a11f4928a7cf5",
    "#3d d128": "a3c1573a7cb98c79",
    "#3d lse d128": "75580f7480ae9798",
    "#4d dk d128": "7c7cc0ddad4f3aa9",
    "#4d dv d128": "9433a0940656fd69",
    "#5d d128": "6cff1868fb821256",
    "#6d dk d128": "7c7cc0ddad4f3aa9",
    "#6d dv d128": "9433a0940656fd69"}


def test_flash_instance_bits_match_the_recorded_run(cuda):
    """The fp32-output parameter joined #3's, #3d's, #4's and #4d's
    templates under ``if constexpr``: their bf16 instances, and the split
    pair's, give the bits they gave before."""
    got = {k: _digest(v) for k, v in _flash_instance_runs(cuda).items()}
    assert got == _FLASH_DIGESTS


# -- ring and Ulysses attention: two context ranks on cuda:0 over gloo --
#
# NCCL refuses two ranks on one card, so the two ranks share cuda:0 over
# gloo (ring hops staged through the host, the all-to-all copied through
# it inside gloo).  Each rank holds half of a [1, 4, 1024, 128] bf16
# sequence; the ring's forward and backward launch only the fp32-output
# instances (rank 0 skips its invisible causal pair), and the shards put
# together hold the dense flash_attention's output and grads to the bf16
# flash tolerances (2e-2 absolute, 1e-2 relative L2).

_CP_SHAPE = (1, 4, 1024, 128)
_CP_CASES = [(True, 0.0), (False, 0.0), (True, 0.1), (False, 0.1)]


def _cp_inputs(dev):
    return [_randn(_CP_SHAPE, 400 + i, dev) for i in range(4)]


def _cp_rank(rank, store, out):
    import datetime
    import torch.distributed as dist
    from apex_tpu_torch.ops import ring_attention, ulysses_attention
    from apex_tpu_torch.transformer import parallel_state as ps
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        ps.initialize_model_parallel(context_parallel_size_=2)
        dev = torch.device("cuda", 0)
        s = _CP_SHAPE[2] // 2
        shard = [t[:, :, rank * s:(rank + 1) * s].contiguous()
                 for t in _cp_inputs(dev)]
        res = {}
        for fn, cases in ((ring_attention, _CP_CASES),
                          (ulysses_attention, [(True, 0.0)])):
            for causal, rate in cases:
                q, k, v = (t.clone().requires_grad_() for t in shard[:3])
                before = _build.launch_counts()
                o = fn(q, k, v, causal=causal, dropout_rate=rate,
                       dropout_seed=1234 if rate else None)
                o.backward(shard[3])
                torch.cuda.synchronize()
                after = _build.launch_counts()
                res[(fn.__name__, causal, rate)] = dict(
                    out=o.detach().cpu(), grads=[t.grad.cpu()
                                                 for t in (q, k, v)],
                    launches={n: after[n] - before[n] for n in after
                              if after[n] != before[n]})
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(res, f"{out}.{rank}")


def test_ring_and_ulysses_attention_two_ranks_on_one_card(cuda, tmp_path):
    import torch.multiprocessing as mp
    mp.start_processes(_cp_rank, nprocs=2, start_method="spawn",
                       args=(str(tmp_path / "store"), str(tmp_path / "out")))
    ranks = [torch.load(f"{tmp_path / 'out'}.{r}", weights_only=False)
             for r in range(2)]
    q, k, v, do = _cp_inputs(cuda)
    for (name, causal, rate), _ in ranks[0].items():
        qd, kd, vd = (t.clone().requires_grad_() for t in (q, k, v))
        dense = attn.flash_attention(qd, kd, vd, causal=causal,
                                     dropout_rate=rate,
                                     dropout_seed=1234 if rate else None)
        dense.backward(do)
        got = [r[(name, causal, rate)] for r in ranks]
        out = torch.cat([g["out"] for g in got], dim=2)
        assert (out.float() - dense.detach().cpu().float()).abs().max() \
            <= 2e-2
        for i, t in enumerate((qd, kd, vd)):
            grad = torch.cat([g["grads"][i] for g in got], dim=2)
            assert _rel_l2(grad.float(), t.grad.cpu().float()) <= 1e-2
        for rank, g in enumerate(got):
            if name == "ulysses_attention":
                want = {"flash_attention": 1, "flash_attention_bwd": 1}
            else:
                pairs = rank + 1 if causal else 2
                suffix = "_drop" if rate else ""
                want = {f"flash_attention{suffix}_f32out": pairs,
                        f"flash_attention_bwd{suffix}_f32out": pairs}
            assert g["launches"] == want, (name, causal, rate, rank,
                                           g["launches"])
