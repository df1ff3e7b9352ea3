"""Tensor parallelism on the card: both kernels at the head slices a model
rank gives them (q, k, v as head slices of (B, L, H, D) storage, the bias
and the SaL tables sliced by head) equal the full call's heads bit for bit,
and a tiny LaTr trains over NCCL (a world of one process a card) as one
process does.

Every test here needs a CUDA card; each skips inside the ``cuda`` fixture
when there is none. The card machine has no JAX, so run these without the
repo's conftest (which imports JAX):

    python -m pytest tests/test_torch_parallel_gpu.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from phoneme_vqa_torch.config import Config
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.dryrun import run_mesh, tiny_latr_config
from phoneme_vqa_torch.ops import flash_attention as fa
from phoneme_vqa_torch.ops import layout
from phoneme_vqa_torch.ops import sal_fused_attention as sfa
from phoneme_vqa_torch.utils.registry import EXECUTORS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def model_layout(*xs):
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
def test_attention_head_slices_equal_the_full_call(cuda, dtype, tp):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, l, d = 4, 12, 131, 64
    q, k, v = model_layout(*(torch.randn(b, h, l, d, generator=g, device=cuda).to(dtype)
                             for _ in range(3)))
    bias, _ = layout.kernel_operand(torch.randn(1, h, l, l, generator=g, device=cuda))
    mask = (torch.rand(b, l, generator=g, device=cuda) > 0.2).to(torch.int32)
    for args in ((bias, mask, False, None), (None, None, False, d ** -0.5),
                 (bias, mask, True, None)):
        full = fa.fused_attention(q, k, v, *args)
        size = h // tp
        for r in range(tp):
            heads = slice(r * size, (r + 1) * size)
            part = fa.fused_attention(q[:, heads], k[:, heads], v[:, heads],
                                      None if args[0] is None else args[0][:, heads], *args[1:])
            assert torch.equal(part, full[:, heads])


@pytest.mark.parametrize("tp", [2, 4])
def test_sal_head_slices_equal_the_full_call(cuda, tp):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, h, l, d = 2, 12, 200, 64
    q, k, v = model_layout(*(torch.randn(b, h, l, d, generator=g, device=cuda).bfloat16()
                             for _ in range(3)))
    bias1d = torch.randn(h, l, l, generator=g, device=cuda).bfloat16()
    cb = torch.randn(h, 122, 122, generator=g, device=cuda)
    cb[:, -1], cb[:, :, -1] = 0, 0
    cb = cb.bfloat16()
    cell = torch.full((b, l), sfa.SENTINEL, dtype=torch.int32, device=cuda)
    cell[:, 40:120] = torch.randint(0, 121, (b, 80), generator=g, device=cuda,
                                    dtype=torch.int32)
    mask = (torch.rand(b, l, generator=g, device=cuda) > 0.2).to(torch.int32)
    full = sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    size = h // tp
    for r in range(tp):
        heads = slice(r * size, (r + 1) * size)
        part = sfa.sal_fused_attention(q[:, heads], k[:, heads], v[:, heads], bias1d[heads],
                                       cb[heads], cell, mask)
        assert torch.equal(part, full[:, heads])


def test_nccl_world_of_one_trains_as_one_process(cuda, tmp_path):
    paths = synthetic.make_latr_fixture(tmp_path)
    config = tiny_latr_config(paths, str(tmp_path / "one"), d_kv=64, num_heads=2, d_model=128,
                              vit_hidden_size=128, vit_num_heads=2)
    one = EXECUTORS.get(config["EXECUTOR"])(Config(config), "train", device="cuda")
    loss = float(one.train_step(one.train_data.gather(np.arange(8))))
    record = run_mesh(dict(config, SAVE_PATH=str(tmp_path / "mesh"), MESH={"data": -1}),
                      torch.cuda.device_count(), device="cuda", steps=1, beams=0)
    np.testing.assert_allclose(record["losses"][0], loss, rtol=1e-5)
    saved = torch.load(record["checkpoint"], weights_only=True)["params"]
    for name, value in one.state.params.items():
        torch.testing.assert_close(saved[name].to(value.device), value.detach(), rtol=1e-4,
                                   atol=2e-5)
    assert record["restored_bit_for_bit"] and record["restored_opt_bit_for_bit"]
    assert os.path.isfile(record["checkpoint"])
