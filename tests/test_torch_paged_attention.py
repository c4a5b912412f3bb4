"""Port parity: ``apex_tpu_torch.ops.paged_attention`` against the JAX
Pallas ``_paged_kernel`` (forced with ``use_kernel=True``, interpret
mode) on the same numpy pool.

Ragged lengths include 0 (emits zeros), page boundaries (16, 17) and a
full window; GQA group 2; a shuffled page table whose dead entries
point at the trash page; the port reads one layer of a 5-D
``[pages, layers, kv_heads, page_size, head_dim]`` pool through a
strided view, as the engine does.  Tolerance: fp32 2e-5 (both fp32,
base-2 online vs one-pass softmax); bf16 one bf16 ulp at the output's
magnitude (both round P to bf16 for P·V and the output once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged,
)
from apex_tpu_torch.ops.paged_attention import paged_decode_attention

SLOTS, H, KVH, D, PS, MPPS, LAYERS = 5, 4, 2, 32, 16, 4, 3
LENGTHS = [0, 1, 16, 17, 64]


def _pool(seed=0):
    rng = np.random.RandomState(seed)
    n_pages = SLOTS * MPPS                 # + 1 trash page at the end
    shape = (n_pages + 1, LAYERS, KVH, PS, D)
    pool_k = rng.randn(*shape).astype(np.float32)
    pool_v = rng.randn(*shape).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((SLOTS, MPPS), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(LENGTHS):
        need = -(-n // PS)
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    q = rng.randn(SLOTS, H, D).astype(np.float32)
    return q, pool_k, pool_v, table, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 2])
def test_paged_decode_matches_jax_kernel(layer, dtype):
    q, pk, pv, table, lengths = _pool(seed=layer)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_paged(jnp.asarray(q, jd), jnp.asarray(pk[:, layer], jd),
                    jnp.asarray(pv[:, layer], jd), jnp.asarray(table),
                    jnp.asarray(lengths), use_kernel=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tk = torch.from_numpy(pk).to(td)
    tv = torch.from_numpy(pv).to(td)
    got = paged_decode_attention(
        torch.from_numpy(q).to(td), tk[:, layer], tv[:, layer],
        torch.from_numpy(table), torch.from_numpy(lengths)).float().numpy()
    assert got.shape == (SLOTS, H, D)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
    else:
        atol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert np.all(got[0] == 0)             # the length-0 slot


def test_four_dim_query_layout_matches():
    """``q [slots, h, 1, d]`` in, ``[slots, h, 1, d]`` out."""
    q, pk, pv, table, lengths = _pool(seed=4)
    args = (torch.from_numpy(pk[:, 1]), torch.from_numpy(pv[:, 1]),
            torch.from_numpy(table), torch.from_numpy(lengths))
    three = paged_decode_attention(torch.from_numpy(q), *args)
    four = paged_decode_attention(torch.from_numpy(q)[:, :, None], *args)
    assert four.shape == (SLOTS, H, 1, D)
    assert torch.equal(four[:, :, 0], three)


def test_bad_operands_raise():
    q, pk, pv, table, lengths = _pool()
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError, match="kv_heads"):
        paged_decode_attention(tq[:, :3], torch.from_numpy(pk[:, 0]),
                               torch.from_numpy(pv[:, 0]),
                               torch.from_numpy(table),
                               torch.from_numpy(lengths))
    with pytest.raises(ValueError, match="q_len == 1"):
        paged_decode_attention(torch.zeros(SLOTS, H, 2, D),
                               torch.from_numpy(pk[:, 0]),
                               torch.from_numpy(pv[:, 0]),
                               torch.from_numpy(table),
                               torch.from_numpy(lengths))
