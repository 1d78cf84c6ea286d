"""Training losses (PCC, Dice, exponential Dice), the port of
``multimodal_3d_image_segmentation_tpu/losses.py``.

Every loss takes ``(y_pred, y_true)`` with one-hot ground truth,
channel-first (B, C, *spatial), reduces over the spatial axes per (batch,
label) and averages (upstream ``nets/custom_losses.py:17-133``).
"""
from __future__ import annotations

import torch

__all__ = ["corrcoef", "pcc_loss", "dice_coef", "dice_loss", "exp_dice_loss",
           "PCCLoss", "DiceLoss", "ExpDiceLoss", "get_loss"]

_EPS = 1e-7


def _spatial_axes(ndim: int):
    if ndim not in (3, 4, 5):
        raise ValueError(f"(B, C, *spatial) with 1-3 spatial axes expected, "
                         f"got {ndim} axes")
    return tuple(range(2, ndim))


def corrcoef(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Pearson correlation per (batch, label) over the spatial axes."""
    axis = _spatial_axes(y_true.dim())
    y_true = y_true - y_true.mean(dim=axis, keepdim=True)
    y_pred = y_pred - y_pred.mean(dim=axis, keepdim=True)
    tp = (y_true * y_pred).sum(dim=axis)
    tt = y_true.square().sum(dim=axis)
    pp = y_pred.square().sum(dim=axis)
    return tp / torch.sqrt(tt * pp + _EPS)


def pcc_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """PCC loss = mean(1 - (r + 1) / 2)."""
    r = corrcoef(y_pred, y_true)
    return (1.0 - (r + 1.0) * 0.5).mean()


def dice_coef(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Soft Dice per (batch, label)."""
    axis = _spatial_axes(y_true.dim())
    intersection = (y_true * y_pred).sum(dim=axis)
    union = (y_true + y_pred).sum(dim=axis)
    return 2.0 * intersection / (union + _EPS)


def dice_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return (1.0 - dice_coef(y_pred, y_true)).mean()


def exp_dice_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                  exp: float = 0.3) -> torch.Tensor:
    """Exponential logarithmic Dice loss (MICCAI 2018)."""
    d = dice_coef(y_pred, y_true).clamp(_EPS, 1.0 - _EPS)
    return torch.pow(-torch.log(d), exp).mean()


class PCCLoss:
    def __call__(self, y_pred, y_true):
        return pcc_loss(y_pred, y_true)


class DiceLoss:
    def __call__(self, y_pred, y_true):
        return dice_loss(y_pred, y_true)


class ExpDiceLoss:
    def __init__(self, exp: float = 0.3):
        self.exp = exp

    def __call__(self, y_pred, y_true):
        return exp_dice_loss(y_pred, y_true, self.exp)


_LOSSES = {"PCCLoss": PCCLoss, "DiceLoss": DiceLoss, "ExpDiceLoss": ExpDiceLoss}


def get_loss(loss_name: str, **kwargs):
    """``[loss]`` section -> loss function; 'CrossEntropyLoss' (or
    'cross_entropy', optional ``weight``) is the upstream
    ``torch.nn.CrossEntropyLoss`` fed the models' softmax probabilities,
    which it treats as logits: a softmax applied twice, kept for value
    parity with the reference."""
    if loss_name in _LOSSES:
        return _LOSSES[loss_name](**kwargs)
    if loss_name in ("CrossEntropyLoss", "cross_entropy"):
        weight = kwargs.pop("weight", None)
        if kwargs:
            raise ValueError(
                f"Unsupported cross-entropy args: {sorted(kwargs)}")

        def ce(y_pred, y_true):
            logp = torch.log_softmax(y_pred, dim=1)
            if weight is None:
                return -(y_true * logp).sum(dim=1).mean()
            w = torch.as_tensor(weight, dtype=torch.float32,
                                device=y_pred.device)
            wc = w.reshape((1, -1) + (1,) * (y_true.dim() - 2))
            per_w = -(y_true * (logp * wc)).sum(dim=1)
            pix_w = (y_true * wc).sum(dim=1)
            return per_w.sum() / pix_w.sum()
        return ce
    raise ValueError(f"Unknown loss {loss_name!r}")
