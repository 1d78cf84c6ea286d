"""The port's depth-sharded V-Net-DS against the JAX package's on 2 gloo
ranks, the two cases that ``tests/test_torch_sharded.py`` leaves out (the
module docstring there has the set-up and the tolerances): both levels
sharded, with residual taps and deep supervision, and the self-normalizing
SELU variant. A file of its own, so that the two halves of the JAX side's
interpret-mode work can run on two test workers."""
import torch

from test_torch_sharded import highest, vnet_world  # noqa: F401

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


def test_sharded_vnet_matches_jax_on_2_ranks_sharded_levels(
        tmp_path, highest, monkeypatch):  # noqa: F811
    vnet_world(2, tmp_path, monkeypatch, [0, 4])
