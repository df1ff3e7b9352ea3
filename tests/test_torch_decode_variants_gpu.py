"""The decode variants on the card at serving shapes: a K-token window
(``decode_step_k``) of the T5-base decoder over a 327-token encoder,
through the attention kernel where its cross-attention has 16 queries, and
beam search over the PhonemeSaL-base decoder with B·K = 128 rows.

Every test here needs a CUDA card; each skips inside the ``cuda`` fixture
when there is none. The card machine has no JAX, so run these without the
repo's conftest (which imports JAX):

    python -m pytest tests/test_torch_decode_variants_gpu.py --noconftest -q
"""

import pytest
import torch

from phoneme_vqa_torch import decode
from phoneme_vqa_torch.decode.beam import top_k_stable
from phoneme_vqa_torch.models import custom_decoder as cd_mod
from phoneme_vqa_torch.models import t5 as t5_mod
from phoneme_vqa_torch.models.latr import init_random_
from phoneme_vqa_torch.ops import attention as attn_mod
from phoneme_vqa_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

B, L_ENC, T = 32, 327, 20
# vit5-base's decoder (configs/latr.yaml) and the PhonemeSaL-base decoder
# (configs/phonemesal.yaml: 4 layers over 253 phoneme ids)
T5_BASE = dict(vocab_size=36096, d_model=768, d_kv=64, num_heads=12, d_ff=3072, num_layers=1,
               num_decoder_layers=12, dropout_rate=0.0)
PSAL_DECODER = dict(vocab_size=253, d_model=768, num_heads=12, num_layers=4, d_ff=2048,
                    dropout_rate=0.0, pad_id=0, bos_id=1, eos_id=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encoder(device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    enc_out = torch.randn(B, L_ENC, 768, generator=g).to(device)
    enc_mask = torch.ones(B, L_ENC, dtype=torch.int32)
    enc_mask[::3, 200:] = 0
    return enc_out, enc_mask.to(device)


def _t5(device, dtype):
    model = t5_mod.T5(t5_mod.T5Config(dtype=dtype, **T5_BASE), device).eval()
    return init_random_(model, torch.Generator(device=device).manual_seed(0))


def test_a_sixteen_token_window_goes_through_the_kernel_and_equals_plain(cuda):
    """f32: one K=16 window at per-row positions (the cross-attention's 16
    queries launch the kernel in each of the 12 layers) against the same
    window with plain attention, and a K=4 window against its four
    one-token steps."""
    model = _t5(cuda, torch.float32)
    enc_out, enc_mask = _encoder(cuda)
    tokens = torch.randint(2, 36096, (B, 16), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    pos = torch.zeros(B, dtype=torch.long, device=cuda)
    with torch.inference_mode():
        cache, bias = model.init_cache(enc_out, T)
        before = fa.LAUNCHES
        got, _ = model.decode_step_k(tokens, {n: v.clone() for n, v in cache.items()}, pos, bias,
                                     enc_mask)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 12
        saved = t5_mod.dot_product_attention
        t5_mod.dot_product_attention = lambda q, k, v, bias=None, key_mask=None, causal=False, \
            scale=None: attn_mod.reference_attention(q, k, v, bias, key_mask, causal, scale)
        try:
            want, _ = model.decode_step_k(tokens, {n: v.clone() for n, v in cache.items()}, pos,
                                          bias, enc_mask)
        finally:
            t5_mod.dot_product_attention = saved
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)

        steps, ones = [], {n: v.clone() for n, v in cache.items()}
        for i in range(4):
            logits, ones = model.decode_step(tokens[:, i], ones, i, bias, enc_mask)
            steps.append(logits)
        window, _ = model.decode_step_k(tokens[:, :4], {n: v.clone() for n, v in cache.items()},
                                        pos, bias, enc_mask)
    want = torch.stack(steps, 1)
    err = float((window - want).norm() / want.norm())
    assert err < 1e-4, err


def test_top_k_orders_ties_on_the_card_as_on_the_cpu(cuda):
    """The beam's top-K: ties lower index first on both devices (at step 0
    every beam but the first sits at NEG, where f32 rounds NEG + logp to
    NEG)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, 4 * 253, generator=g)
    x[:, 253:] = decode.beam.NEG + x[:, 253:] * 10  # rounds to NEG
    x[:, 5:40] = x[:, 4:5]  # ties among the finite values too
    cpu_vals, cpu_idx = top_k_stable(x, 64)
    vals, idx = top_k_stable(x.to(cuda), 64)
    torch.testing.assert_close(vals.cpu(), cpu_vals, atol=0, rtol=0)
    torch.testing.assert_close(idx.cpu(), cpu_idx, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_over_128_rows_on_the_card(cuda, dtype):
    """Beam search over the PhonemeSaL-base decoder with B=32 and K=4: a
    beam of one is greedy; with K=4 the scores are finite log-probabilities
    and finished beams emit only pad."""
    model = cd_mod.CustomDecoder(cd_mod.CustomDecoderConfig(dtype=dtype, **PSAL_DECODER), cuda)
    init_random_(model.eval(), torch.Generator(device=cuda).manual_seed(3))
    with torch.no_grad():  # a larger EOS bias: rows end at several lengths
        model.lm_head.bias[2] += 2.5
    enc_out, enc_mask = _encoder(cuda, seed=4)

    def run(k, beam=True):
        mask = decode.expand_to_beams(enc_mask, k)
        step = lambda tok, c, i: model.step(tok, c, i, mask)
        with torch.inference_mode():
            cache = decode.expand_to_beams(model.init_cache(enc_out, 40), k)
            if not beam:
                return decode.greedy_decode(step, cache, B, 40, 1, 2, 0, cuda, with_scores=True)
            return decode.beam_decode(step, cache, B, k, 40, 1, 2, 0, cuda, with_scores=True)

    greedy, greedy_s = run(1, beam=False)
    one, one_s = run(1)
    torch.testing.assert_close(one, greedy, atol=0, rtol=0)
    torch.testing.assert_close(one_s, greedy_s, atol=1e-6, rtol=1e-6)
    got, scores = run(4)
    assert got.shape == (B, 40) and torch.isfinite(scores).all()
    assert (scores <= 0).all() and (scores > -1e3).all()
    rows = got.tolist()
    assert any(2 in r for r in rows)
    for r in rows:
        if 2 in r:
            assert set(r[r.index(2) + 1:]) <= {0}
