"""The port's attention core against the JAX package on the CPU.

The same numpy inputs go through ``phoneme_vqa_tpu.ops`` (the XLA reference
and the Pallas kernel in interpret mode) and ``phoneme_vqa_torch.ops``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch.ops import attention as t_attn
from phoneme_vqa_torch.ops import flash_attention as t_flash
from phoneme_vqa_torch.ops.rel_bias import relative_position_bucket as t_bucket
from phoneme_vqa_tpu.ops.attention import reference_attention as j_reference
from phoneme_vqa_tpu.ops.flash_attention import fused_attention as j_fused
from phoneme_vqa_tpu.ops.rel_bias import relative_position_bucket as j_bucket

ATOL = RTOL = 2e-5  # f32 on both sides; sums run in another order


@pytest.mark.parametrize(
    "bidirectional,num_buckets,max_distance",
    [(True, 32, 128), (False, 32, 128), (True, 16, 64), (False, 8, 20)],
)
def test_relative_position_bucket_ids_equal(bidirectional, num_buckets, max_distance):
    rel = np.arange(-400, 400, dtype=np.int32)[None, :] - np.arange(0, 40, dtype=np.int32)[:, None]
    want = np.asarray(j_bucket(jnp.asarray(rel), bidirectional, num_buckets, max_distance))
    got = t_bucket(torch.from_numpy(rel), bidirectional, num_buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, want)


def _inputs(b, h, lq, lk, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    bias = rng.randn(b, h, lq, lk).astype(np.float32)
    mask = (rng.rand(b, lk) > 0.3).astype(np.int32)
    mask[0, 0] = 1
    mask[-1] = 0  # a row that attends nowhere averages v over the Lk keys
    return q, k, v, bias, mask


OPTIONS = list(itertools.product(("none", "one", "batch"), (False, True), (False, True), (None, 0.5)))


@pytest.mark.parametrize("bias_kind,use_mask,causal,scale", OPTIONS)
def test_plain_attention_matches_jax_reference_and_pallas(bias_kind, use_mask, causal, scale):
    b, h, l, d = 2, 3, 17, 8
    q, k, v, bias, mask = _inputs(b, h, l, l, d)
    bias = {"none": None, "one": bias[:1], "batch": bias}[bias_kind]
    mask = mask if use_mask else None
    j = lambda x: None if x is None else jnp.asarray(x)
    t = lambda x: None if x is None else torch.from_numpy(x)
    want_ref = np.asarray(j_reference(j(q), j(k), j(v), j(bias), j(mask), causal, scale))
    want_pallas = np.asarray(
        j_fused(j(q), j(k), j(v), j(bias), j(mask), causal=causal, scale=scale, interpret=True)
    )
    got = t_attn.reference_attention(t(q), t(k), t(v), t(bias), t(mask), causal, scale).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
    # a row with no attendable key is where the two JAX versions part: the
    # Pallas kernel also averages over its padded keys; the reference, and
    # the port, over the Lk real keys only
    live = slice(None) if mask is None else mask.any(axis=1)
    np.testing.assert_allclose(got[live], want_pallas[live], atol=ATOL, rtol=RTOL)


def test_cpu_dispatch_and_wrapper_take_the_plain_version():
    q, k, v, bias, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 20, 33, 8, seed=1))
    before = t_flash.LAUNCHES
    want = t_attn.reference_attention(q, k, v, None, mask, False, None)
    torch.testing.assert_close(t_attn.dot_product_attention(q, k, v, key_mask=mask.bool()), want)
    torch.testing.assert_close(t_flash.fused_attention(q, k, v, None, mask), want)
    assert t_flash.LAUNCHES == before  # no kernel on the CPU


def test_cross_lengths_match_jax_reference():
    q, k, v, _, mask = _inputs(2, 3, 5, 29, 16, seed=2)
    want = np.asarray(j_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                  jnp.asarray(mask)))
    got = t_attn.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)), None,
                                     torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
