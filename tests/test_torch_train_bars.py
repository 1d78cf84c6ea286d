"""The whole-model train-step rules (``utils/train_bars.py``) on the CPU:
a tower's plain twins path meets them against the module path, a fault
planted in one gradient or TF32-rounded gradients fail them, the models
get their kernel wrappers back after ``plain_twins``, and the diagnostic
refuses to run on the CPU unless asked.

Small towers at random init (filters 8, two blocks, a 12x16x16 volume):
the readings of the plain twins path and the module path against a
float64 evaluation of the same step.
"""
import numpy as np
import pytest
import torch

from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.models import (
    HartleyMHASeg, NeuralOperatorSeg, architectures)
from multimodal_3d_image_segmentation_tpu_torch.utils import train_bars
from multimodal_3d_image_segmentation_tpu_torch.utils.labels import \
    to_categorical

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

TOWERS = {
    "HartleyMHASeg": (HartleyMHASeg, dict(
        in_channels=2, out_channels=4, filters=8, num_transform_blocks=2,
        num_heads=2, num_modes=(2, 3, 2), patch_size=None)),
    "HNOSeg": (NeuralOperatorSeg, dict(
        in_channels=2, out_channels=4, filters=8, num_transform_blocks=2,
        num_modes=(2, 3, 3), transform_type="Hartley")),
    "FNOSeg": (NeuralOperatorSeg, dict(
        in_channels=2, out_channels=4, filters=8, num_transform_blocks=2,
        num_modes=(2, 3, 3), transform_type="Fourier")),
}
SHAPE = (12, 16, 16)


def _grads(cls, kw, state, use_kernels, dtype, twins=False):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 2) + SHAPE)).to(dtype)
    y1h = to_categorical(torch.from_numpy(
        rng.integers(0, 4, (1, 1) + SHAPE).astype(np.float32)), 4).to(dtype)
    model = cls(**kw, use_kernels=use_kernels).to(dtype)
    model.load_state_dict(state)
    if twins:
        with train_bars.plain_twins():
            return train_bars._step(model, x, y1h)
    return train_bars._step(model, x, y1h)


@pytest.fixture(scope="module", params=sorted(TOWERS))
def tower(request):
    cls, kw = TOWERS[request.param]
    state = cls(**kw, generator=torch.Generator().manual_seed(3)).state_dict()
    paths = {"plain": _grads(cls, kw, state, False, torch.float32),
             "twins": _grads(cls, kw, state, True, torch.float32, True)}
    ref = _grads(cls, kw, state, False, torch.float64)
    return paths, ref


def test_plain_twins_path_meets_the_rules(tower):
    paths, ref = tower
    r = train_bars.readings(paths, ref)
    assert train_bars.tower_failures(r, "twins", ("plain",)) == []
    assert train_bars.over_bars(r, "plain", ("plain",)) == []


def test_a_fault_in_one_gradient_fails_the_rules(tower):
    """The last block's w_cc_t columns of its conv_concat weight gradient
    scaled by 1.05: that tensor, and only it, misses BARS_TRAIN_SELU."""
    paths, ref = tower
    name = "layers.1.conv_concat.op.weight"
    g = paths["twins"][name].clone()
    g.view(g.shape[0], -1)[:, :g.shape[0]] *= 1.05
    r = train_bars.readings(
        dict(paths, twins={**paths["twins"], name: g}), ref)
    failed = train_bars.tower_failures(r, "twins", ("plain",))
    assert name in failed
    assert not [k for k in failed if k.startswith("layers.") and k != name]


def test_tf32_rounded_gradients_fail_the_rules(tower):
    """Every gradient rounded to TF32's 10-bit mantissa, as a product on
    TF32 tensor cores would leave it."""
    paths, ref = tower
    rounded = {k: (v.view(torch.int32) & ~0x1FFF).view(torch.float32)
               for k, v in paths["twins"].items()}
    r = train_bars.readings(dict(paths, twins=rounded), ref)
    assert len(train_bars.tower_failures(r, "twins", ("plain",))) > 1


def test_plain_twins_restores_the_kernel_wrappers():
    real = {name: getattr(architectures, name) for name in train_bars._TWINS}
    with pytest.raises(RuntimeError):
        with train_bars.plain_twins():
            assert (architectures.fused_tower_block
                    is kernels.tower_block_plain)
            raise RuntimeError
    assert {name: getattr(architectures, name)
            for name in train_bars._TWINS} == real


def test_train_bars_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        train_bars.main([])
