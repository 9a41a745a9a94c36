"""The checks of ``tests/test_torch_slice.py`` on a screw pile and an hnm
pile: the front half of one attempt with the cone sampler alone, and with
the canonical's NOCS-transfer sampler beside it.  Both classes take a
1,024-grasp codebook: from 64 grasps JAX's NOCS sampler keeps nothing on
either pile.  With the cone's candidates dropped (``off``) the hnm pile is
checked; the screw's 73,728 NOCS-transfer poses make each canonical case
about a minute on the CPU, so the screw runs the ``on`` case alone.
"""
import pytest
import torch

from test_torch_slice import _check_slice, _check_slice_with_canonical, _settled

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["screw", "hnm"])
def class_settled(request):
    return _settled(request.param)


def test_slice_matches_jax_for_class(class_settled):
    _check_slice(class_settled)


@pytest.mark.parametrize("class_settled,cone", [("screw", "on"), ("hnm", "on"), ("hnm", "off")],
                         indirect=["class_settled"])
def test_slice_with_canonical_matches_jax_for_class(class_settled, cone):
    _check_slice_with_canonical(class_settled, cone)
