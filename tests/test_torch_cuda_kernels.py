"""The CUDA attention kernels against their plain version, on the card.

Marked ``cuda``; each test skips where there is no CUDA device (the CUDA
kernels have no CPU mode). On a GPU machine:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q

Tolerance: float32 1e-5 (summation order); bf16 1e-2 against the plain
version in float32 on the same values (probabilities and output rounded to
bf16).
"""

import pytest
import torch

from office_person_detection_vit_torch.kernels import attention as kernels
from office_person_detection_vit_torch.ops.attention import attention_reference, multi_head_attention

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.load_library()


def _case(B, H, Lq, Lk, D, dtype, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g).to("cuda", dtype) for L in (Lq, Lk, Lk))
    mask = None
    if masked:
        mask = torch.rand(B, Lk, generator=g) > 0.3
        mask[0] = False  # a fully-masked batch entry: mean(V)
        mask = mask.cuda()
    return q, k, v, mask


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", kernels.HEAD_DIMS)
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain(card, fn, dtype, D, masked):
    q, k, v, mask = _case(2, 3, 67, 131, D, dtype, masked)
    before = kernels.launch_counts[fn.__name__]
    out = fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts[fn.__name__] == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), mask)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


def test_dispatch_takes_the_kernels(card):
    q, k, v, mask = _case(1, 2, 50, 920, 32, torch.float32, True)
    before = dict(kernels.launch_counts)
    multi_head_attention(q, k, v, mask)
    multi_head_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    assert kernels.launch_counts["attention_flash"] == before["attention_flash"] + 1
    assert kernels.launch_counts["attention_whole_kv"] == before["attention_whole_kv"] + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, k, v, _ = _case(1, 2, 8, 8, 32, torch.float32, False)
    with pytest.raises(ValueError):
        kernels.attention_flash(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        kernels.attention_flash(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        kernels.attention_whole_kv(*_case(1, 1, 8, 4000, 32, torch.float32, False)[:3])
