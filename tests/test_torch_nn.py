"""Port parity for the nets (``nn/pointnet.py``, ``nn/voxelnet.py``) with the
tracked weights of each class, converted by ``convert.py`` from the port's
own checkpoint reader.

Tolerances: PointNet runs in f32 on both sides, so logits agree to f32
rounding of their size (2e-6 of the largest logit, at least 2e-6 absolute:
the NUNOCS logits reach ~80) and the STN transforms within 1e-5.
``voxelize`` is exact against JAX's jitted ``voxelize`` (as the net was
trained and is run: XLA turns its division by the voxel size into a
multiplication by the reciprocal, which moves a point on a voxel face one
voxel down).  SegNet runs its convolutions in bfloat16 on both sides
(JAX's default ``compute_dtype``), so the port's offsets are held to the
JAX module, jitted and run op by op, within 2e-3 m at most and 5e-4 m at
the 99th percentile (offsets are bounded by 0.05 m), and the objectness
signs equal on >= 99.5% of points; at a reduced 32x32x16 grid of the
trained 2 mm voxels (the weights do not depend on the grid).  The layer
layouts (Dense, Conv, the flipped ConvTranspose) are held in f32 against
single flax layers.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from catgrasp_tpu.nn.pointnet import PointNetCls as JPointNetCls
from catgrasp_tpu.nn.pointnet import PointNetSeg as JPointNetSeg
from catgrasp_tpu.nn.voxelnet import SegNet as JSegNet
from catgrasp_tpu.nn.voxelnet import voxelize as jvoxelize
from catgrasp_tpu.nn import voxelnet as jvoxelnet
from catgrasp_tpu_torch import convert
from catgrasp_tpu_torch.geom import primitives as prim
from catgrasp_tpu_torch.nn.pointnet import GN_EPS, PointNetCls, PointNetSeg
from catgrasp_tpu_torch.nn.voxelnet import SegNet, voxelize
from catgrasp_tpu_torch.ops.row_group_norm import row_group_norm_relu
from catgrasp_tpu_torch.predict.ckpt import read_params

torch.set_num_threads(2)
CLASSES = ["nut", "screw", "hnm"]
GRID = (32, 32, 16)
VOXEL = 0.002  # config_seg.yml's


def _params(cls, role):
    return read_params(f"artifacts_tracked/{cls}/{role}/best_val.ckpt")


def _clouds(batch, n, seed=0):
    """(B, N, 6) xyz at object scale and unit normals."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 0.3, (batch, n, 3))
    nrm = rng.normal(size=(batch, n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([xyz, nrm], -1).astype(np.float32)


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("role", ["grasp", "nunocs"])
def test_pointnet_matches_jax(cls, role):
    """``PointNetCls`` with the grasp net's weights (10 bins) on 3 clouds of
    1,024 points, ``PointNetSeg`` with the NUNOCS net's (300 bins) on 2 of
    512: logits and both STN transforms."""
    params = _params(cls, role)
    if role == "grasp":
        jnet, net, x = JPointNetCls(n_out=10), PointNetCls(10), _clouds(3, 1024)
    else:
        jnet, net, x = JPointNetSeg(n_out=300), PointNetSeg(300), _clouds(2, 512)
    net.load_state_dict(convert.flax_state_dict(params))
    lj, fj = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        lp, fp = net(torch.as_tensor(x))
    lj = np.asarray(lj)
    np.testing.assert_allclose(lp.numpy(), lj, rtol=0, atol=2e-6 * max(1.0, np.abs(lj).max()))
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=1e-5)
    with torch.no_grad():  # the input STN, alone
        tp = net.PointNetEncoder_0.STN_0(torch.as_tensor(x))
    assert tp.shape == (len(x), 3, 3)


def test_voxelize_is_exact():
    """Mean features and occupancy per voxel, and each point's flat index,
    equal JAX's jitted ``voxelize``; points outside the grid clip to its
    border voxels, and points on voxel faces land where the jitted JAX
    function puts them (JAX run op by op puts some a voxel higher)."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-0.01, 0.075, (5000, 3)).astype(np.float32)
    xyz[:500] = rng.integers(-2, 36, (500, 3)) * np.float32(VOXEL)  # on voxel faces
    feats = rng.normal(size=(5000, 3)).astype(np.float32)
    origin = np.float32([0.0, 0.0, 0.0])
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(origin))
    gj, fj = jax.jit(jvoxelize, static_argnums=(3, 4))(*args, VOXEL, GRID)
    gp, fp = voxelize(torch.as_tensor(xyz), torch.as_tensor(feats), torch.as_tensor(origin),
                      VOXEL, GRID)
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(gj))
    assert gp.shape == (*GRID, 4) and (xyz < 0).any() and (xyz > 0.064).any()
    assert (np.asarray(jvoxelize(*args, VOXEL, GRID)[1]) != fp.numpy()).any()


def _scene_cloud(cls):
    """Two instances of ``cls`` side by side: surface points and normals."""
    rng = np.random.default_rng(1)
    pts, nrm = [], []
    for i, t in enumerate(([0.0, 0.0, 0.0], [0.025, 0.012, 0.003])):
        p, n = prim.make_instance(cls, "test", i).sample_surface(2500, rng, return_normals=True)
        pts.append(p + np.float32(t))
        nrm.append(n)
    return np.concatenate(pts), np.concatenate(nrm)


@pytest.mark.parametrize("cls", CLASSES)
def test_segnet_matches_jax(cls, monkeypatch):
    """The seg net of ``cls`` on two instances, bf16 convolutions on both
    sides: offsets and objectness signs within the bf16 tolerances of the
    jitted JAX module (as the JAX predicter runs it), and of the JAX module
    run op by op (each layer rounded as flax declares it) with its
    ``voxelize`` jitted.  The hnm instances have faces on voxel faces."""
    params = _params(cls, "seg")
    xyz, nrm = _scene_cloud(cls)
    origin = xyz.min(0) - 0.01
    jnet = JSegNet(voxel_size=VOXEL, grid_dims=GRID)
    args = ({"params": params}, jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(origin))
    oj, bj = (np.asarray(v) for v in jax.jit(jnet.apply)(*args))
    monkeypatch.setattr(jvoxelnet, "voxelize", jax.jit(jvoxelize, static_argnums=(3, 4)))
    oe, be = (np.asarray(v) for v in jnet.apply(*args))
    net = SegNet(voxel_size=VOXEL, grid_dims=GRID)
    net.load_state_dict(convert.flax_state_dict(params))
    with torch.no_grad():
        op, bp = (v.numpy() for v in net(torch.as_tensor(xyz), torch.as_tensor(nrm),
                                          torch.as_tensor(origin)))
    for o, b in ((oj, bj), (oe, be)):
        d = np.abs(op - o)
        assert d.max() <= 2e-3 and np.percentile(d, 99) <= 5e-4, (d.max(), np.percentile(d, 99))
        assert ((bp > 0) == (b > 0)).mean() >= 0.995
    assert op.dtype == bp.dtype == np.float32


def _flax_layer_state(layer, params):
    """The state of one flax layer as the port's converter gives it, under
    a module name of the layer's kind."""
    name = {fnn.Conv: "Conv_0", fnn.ConvTranspose: "ConvTranspose_0"}[type(layer)]
    sd = convert.flax_state_dict({name: params})
    return sd[f"{name}.weight"], sd[f"{name}.bias"]


def test_conv_layouts_match_flax():
    """A 3x3x3 SAME conv and a 2x2x2 stride-2 transposed conv in f32 with
    random weights: flax's outputs equal torch's ``conv3d`` /
    ``conv_transpose3d`` on the converted kernels (DHWIO -> OIDHW; DHWIO ->
    IODHW flipped), channels last against channels first.  Without the
    flip the transposed conv disagrees."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 6, 8, 4, 5)).astype(np.float32)  # NDHWC
    xt = torch.as_tensor(x).permute(0, 4, 1, 2, 3)
    for layer, torch_fn in ((fnn.Conv(7, (3, 3, 3)), lambda w, b: F.conv3d(xt, w, b, padding=1)),
                            (fnn.ConvTranspose(7, (2, 2, 2), strides=(2, 2, 2)),
                             lambda w, b: F.conv_transpose3d(xt, w, b, stride=2))):
        p = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        p = {"kernel": np.asarray(p["kernel"]), "bias": rng.normal(size=7).astype(np.float32)}
        yj = np.asarray(layer.apply({"params": p}, jnp.asarray(x)))
        w, b = _flax_layer_state(layer, p)
        yp = torch_fn(w, b).permute(0, 2, 3, 4, 1).numpy()
        np.testing.assert_allclose(yp, yj, atol=1e-5)
        if isinstance(layer, fnn.ConvTranspose):
            unflipped = torch_fn(torch.flip(w, (2, 3, 4)), b).permute(0, 2, 3, 4, 1).numpy()
            assert np.abs(unflipped - yj).max() > 0.1
    with pytest.raises(ValueError, match="unexpected kernel"):
        convert.flax_state_dict({"Conv_0": {"kernel": np.zeros((3, 3, 2, 2))}})


def test_segnet_unet_input_keeps_the_one_scene_layout():
    """The seg net hands its U-Net a contiguous (B, C, D, H, W) grid.  On one
    scene that gives, bit for bit, the features of the unsqueezed view
    ``grid.permute(3, 0, 1, 2)[None]``, whose size-1 batch stride (C) keeps
    torch from taking channels-last conv kernels, which round the bf16
    convs otherwise."""
    xyz, nrm = _scene_cloud("nut")
    origin = xyz.min(0) - 0.01
    net = SegNet(voxel_size=VOXEL, grid_dims=GRID)
    net.load_state_dict(convert.flax_state_dict(_params("nut", "seg")))
    with torch.no_grad():
        grid, _ = voxelize(torch.as_tensor(xyz)[None], torch.as_tensor(nrm)[None],
                           torch.as_tensor(origin)[None], VOXEL, GRID)
        u_batch = net.VoxelUNet_0(grid.permute(0, 4, 1, 2, 3).contiguous())
        u_view = net.VoxelUNet_0(grid[0].permute(3, 0, 1, 2)[None])
    assert grid.shape == (1, *GRID, 4)
    assert torch.equal(u_batch, u_view)


@pytest.mark.parametrize("m", [1, 4099])
def test_row_group_norm_relu_on_the_cpu_is_the_head_expression(m):
    """On CPU tensors the head's GroupNorm + ReLU op is the expression the
    head had, ``relu(GroupNorm_0(x))``, bit for bit: the output and the
    gradients of x, gamma and beta; no kernel is launched."""
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.normal(0, 2, (m, 1)) + rng.normal(size=(m, 64)), dtype=torch.float32)
    gn = torch.nn.GroupNorm(8, 64, eps=GN_EPS)
    with torch.no_grad():
        gn.weight.copy_(torch.as_tensor(1 + 0.2 * rng.normal(size=64)))
        gn.bias.copy_(torch.as_tensor(0.2 * rng.normal(size=64)))
    dy = torch.as_tensor(rng.normal(size=(m, 64)), dtype=torch.float32)
    n0 = row_group_norm_relu.launches
    outs = []
    for head in (lambda x: F.relu(gn(x)),
                 lambda x: row_group_norm_relu(x, gn.weight, gn.bias, 8, GN_EPS)):
        xs = x.clone().requires_grad_()
        gn.zero_grad()
        y = head(xs)
        y.backward(dy)
        outs.append((y.detach(), xs.grad, gn.weight.grad.clone(), gn.bias.grad.clone()))
    assert 0 < int((outs[0][0] > 0).sum()) < outs[0][0].numel()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert row_group_norm_relu.launches == n0


def test_segnet_state_dict_keys_are_the_checkpoints():
    """The head keeps its ``GroupNorm_0`` parameters under their flax names:
    SegNet's state dict has exactly the keys the converter gives a tracked
    seg checkpoint, and loads it strictly."""
    sd = convert.flax_state_dict(_params("nut", "seg"))
    net = SegNet(voxel_size=VOXEL, grid_dims=GRID)
    assert set(net.state_dict()) == set(sd)
    assert {"GroupNorm_0.weight", "GroupNorm_0.bias", "Dense_0.weight"} <= set(sd)
    net.load_state_dict(sd, strict=True)
