"""The port's JFA and exact EDT (otvm_tpu_torch.nn.edt) on a CUDA card
give the bits they give on the CPU, which are the JAX package's
(tests/test_torch_edt.py):
blob-shaped seed maps at the stream's 512x512 and at the training crop,
batched as trimap_clicks batches them.  On the card the JFA is a CUDA graph
captured at a shape's first call, so each shape takes three inputs, the
later ones through replays.  Needs a card and no JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_edt_cuda.py`."""
import numpy as np
import pytest
import torch

from otvm_tpu_torch.nn import edt


def _blobs(n, h, w, cells, seed):
    grid = torch.from_numpy(np.random.RandomState(seed).rand(n, 1, cells, cells).astype(np.float32))
    up = torch.nn.functional.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)
    return up[:, 0] > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cells", [(2, 512, 512, 12), (8, 320, 320, 9), (2, 45, 70, 5)])
def test_edt_jfa_on_cuda_matches_cpu(n, h, w, cells):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in range(3):
        seeds = _blobs(n, h, w, cells, seed=n + h + seed)
        seeds[seed % n] = False                        # a map without seeds
        want = edt.edt_sq_jfa(seeds)
        got = edt.edt_sq_jfa(seeds.cuda())
        assert torch.equal(got.cpu(), want), f"input {seed}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cells", [(2, 512, 512, 12), (2, 45, 70, 5)])
def test_edt_exact_on_cuda_matches_cpu(n, h, w, cells):
    """The exact EDT on the card (its column pass in blocks of the capped
    temporary: 32 rows at 2 x 512 x 512) gives the CPU's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seeds = _blobs(n, h, w, cells, seed=n + h)
    seeds[1] = False                                   # a map without seeds
    want = edt.edt_sq_exact(seeds)
    assert torch.equal(edt.edt_sq_exact(seeds.cuda()).cpu(), want)
    assert torch.equal(edt.edt_sq_exact(seeds.cuda(), block=7).cpu(), want)
