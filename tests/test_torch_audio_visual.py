"""pytorchvideo_tpu_torch's audio models against the JAX package's, with the
same seeded weights carried across by zoo/from_jax.py: audio-visual
SlowFast (eval logits in f32, a train-mode forward's logits and running
statistics in float64, the deploy form's BN fold, the full-width builder's
every tensor against ``jax.eval_shape``), the acoustic ResNet, and the
layers they add: ``ConvReduce3D``, the acoustic stem, the separable
bottleneck, ``ResBlock``'s ``branch_fusion``, the 2D squeeze-excitation
layer and block, ``PositionalEncoding`` and the sincos tables.

The narrow models have one block a stage and the geometry of the JAX
package's own audio-visual test (tests/test_models_ssl_av.py:14-26): slow
2x32x32, fast 8x32x32, a 32 x 16 spectrogram, head pools ((2, 1, 1), (8, 1,
1), (4, 1, 2)), stem widths (16, 2, 8), which keep the ratios 8 and 2.
Tolerance: rtol 5e-3 / atol 5e-4 (tests/test_models_parity.py:24) unless a
test says otherwise.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchvideo_tpu.accelerate.fuse import fold_conv_bn as jax_fold_conv_bn
from pytorchvideo_tpu.layers import convolutions as jax_convolutions
from pytorchvideo_tpu.layers import positional_encoding as jax_pe
from pytorchvideo_tpu.layers import squeeze_excitation as jax_se
from pytorchvideo_tpu.models import audio_visual_slowfast as jax_av
from pytorchvideo_tpu.models import resnet as jax_resnet
from pytorchvideo_tpu.models import slowfast as jax_slowfast
from pytorchvideo_tpu.models import stem as jax_stem
from pytorchvideo_tpu_torch import layers
from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
from pytorchvideo_tpu_torch.layers import positional_encoding as pe
from pytorchvideo_tpu_torch.layers.norms import BatchNorm
from pytorchvideo_tpu_torch.layers.squeeze_excitation import (
    SqueezeAndExcitationLayer2D,
    create_audio_2d_squeeze_excitation_block,
)
from pytorchvideo_tpu_torch.models import audio_visual_slowfast as av
from pytorchvideo_tpu_torch.models import resnet, slowfast, stem
from pytorchvideo_tpu_torch.zoo.from_jax import jax_variables_to_state_dict
from torch_port_helpers import TOL, random_variables

AV_CLIPS = [(2, 3, 2, 32, 32), (2, 3, 8, 32, 32), (2, 1, 32, 1, 16)]
AV_NARROW = dict(model_num_class=7, dropout_rate=0.0, stem_dim_outs=(16, 2, 8),
                 head_pool_kernel_sizes=((2, 1, 1), (8, 1, 1), (4, 1, 2)),
                 stage_depths=(1, 1, 1, 1))
# The audio-visual defaults create_slowfast takes from the builder's signature.
AV_DEFAULTS = ("slowfast_channel_reduction_ratio", "slowfast_conv_channel_fusion_ratio",
               "input_channels", "stem_conv_kernel_sizes", "stem_conv_strides", "stem_pool",
               "stem_pool_kernel_sizes", "stem_pool_strides", "stage_conv_a_kernel_sizes",
               "stage_conv_b_kernel_sizes", "stage_conv_b_num_groups", "stage_conv_b_dilations",
               "stage_spatial_strides", "stage_temporal_strides", "bottleneck")
FUSION = dict(slowfast_channel_reduction_ratio=8, slowfast_audio_reduction_ratio=2,
              conv_fusion_channel_ratio=2, conv_kernel_size=(7, 1, 1),
              conv_kernel_size_a=(5, 1, 1), conv_stride=(4, 1, 1),
              conv_stride_a=((16, 1, 1), (16, 1, 1), (8, 1, 1), (4, 1, 1), (2, 1, 1)))
AUDIO_CLIP = (2, 1, 16, 1, 12)
ACOUSTIC_NARROW = dict(model_num_class=5, dropout_rate=0.0, stem_dim_out=8,
                       stage_depths=(1, 1, 1, 1), head_pool_kernel_size=(2, 1, 1))
FOLD_REL = 1e-3  # the f32 deploy form against the unfused model, of max |logit|


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax(x):
    """NC... numpy (or a list of them) -> channels-last JAX arrays."""
    if isinstance(x, list):
        return [_jax(p) for p in x]
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _torch(x):
    if isinstance(x, list):
        return [_torch(p) for p in x]
    return torch.from_numpy(x)


def _clip(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _variables(module, x, seed, train_arg=True):
    args = (_jax(x), False) if train_arg else (_jax(x),)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return random_variables(shapes, seed)


def _load(module, variables):
    module.load_state_dict(jax_variables_to_state_dict(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    return module.eval()


def _apply(module, variables, x, *args):
    return np.asarray(jax.jit(lambda v, a: module.apply(v, a, *args))(variables, _jax(x)))


def _run(module, x):
    with torch.no_grad():
        out = module(_torch(x))
    return out.numpy()


def _channels_last(out):
    return np.moveaxis(out, 1, -1)


def _av_kwargs(builder):
    signature = inspect.signature(builder).parameters
    return {key: signature[key].default for key in AV_DEFAULTS}


def _jax_av():
    return jax_slowfast.create_slowfast(
        **_av_kwargs(jax_av.create_audio_visual_slowfast), **AV_NARROW,
        stem_function=(jax_stem.create_res_basic_stem, jax_stem.create_res_basic_stem,
                       jax_stem.create_acoustic_res_basic_stem),
        fusion_builder=jax_av.AudioToSlowFastFusionBuilder(**FUSION).create_module)


def _port_av():
    return slowfast.create_slowfast(
        **_av_kwargs(av.create_audio_visual_slowfast), **AV_NARROW,
        stem_function=(stem.create_res_basic_stem, stem.create_res_basic_stem,
                       stem.create_acoustic_res_basic_stem),
        fusion_builder=av.AudioToSlowFastFusionBuilder(**FUSION, device="cpu").create_module,
        device="cpu")


def _av_inputs(seed=1, dtype=np.float32):
    return [_clip(shape, seed + i, dtype) for i, shape in enumerate(AV_CLIPS)]


_AV = {}


def _av_pair():
    """The narrow JAX and port audio-visual SlowFast with the same weights
    (random BN statistics), made once."""
    if not _AV:
        jax_model = _jax_av()
        variables = _variables(jax_model, _av_inputs(), seed=3)
        _AV.update(jax_model=jax_model, variables=variables,
                   forward=jax.jit(lambda v, a: jax_model.apply(v, a, False)))
    return _AV["jax_model"], _AV["variables"], _load(_port_av(), _AV["variables"]), _AV["forward"]


# --- audio-visual SlowFast --------------------------------------------------

def test_av_slowfast_eval_logits_match_jax():
    jax_model, variables, model, forward = _av_pair()
    x = _av_inputs()
    ref = np.asarray(forward(variables, _jax(x)))
    out = _run(model, x)
    assert out.shape == (2, 7)
    np.testing.assert_allclose(out, ref, **TOL)
    # The audio fusion's widths: fast_out + fusion_dim_in on the slow
    # pathway, fusion stages at stage indices 0-3 only.
    fusions = [block.multipathway_fusion for block in model.blocks[:5]]
    assert all(isinstance(f, av.FuseAudioToFastSlow) for f in fusions[:4]) and fusions[4] is None
    assert [f.block_audio_to_fastslow.stages[-1].conv.out_channels for f in fusions[:4]] == [
        16 + 4, 64 + 16, 128 + 32, 256 + 64]
    assert [f.block_audio_to_fastslow.stages[-1].conv.stride for f in fusions[:4]] == [
        (16, 1, 1), (16, 1, 1), (8, 1, 1), (4, 1, 1)]
    # Each separable bottleneck's branches: spatial (1, 1, 3) first.
    separable = [m for m in model.modules() if isinstance(m, resnet.SeparableBottleneckBlock)]
    assert len(separable) == 2
    assert all([c.kernel_size for c in m.conv_b] == [(1, 1, 3), (3, 1, 1)] for m in separable)


@jax.enable_x64(True)
def test_av_slowfast_train_forward_matches_jax_in_float64():
    # One train-mode forward: logits, and every running statistic moved by
    # the batch's (biased) statistics, as flax's BatchNorm moves them.
    jax_model, variables, model, _ = _av_pair()
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float64), variables)
    before = jax_variables_to_state_dict(variables["params"], variables["batch_stats"])
    model.load_state_dict(before)
    x = _av_inputs(seed=5, dtype=np.float64)
    ref, mutated = jax.jit(lambda v, a: jax_model.apply(v, a, True, mutable=["batch_stats"]))(
        variables, _jax(x))
    model.double().train()
    with torch.no_grad():
        out = model(_torch(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    after = jax_variables_to_state_dict(
        variables["params"], jax.tree_util.tree_map(np.array, mutated["batch_stats"]))
    state = model.state_dict()
    keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, BatchNorm) for m in model.modules())
    for key in keys:
        assert not torch.equal(after[key], before[key]), key
        np.testing.assert_allclose(state[key].numpy(), after[key].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=key)


def _shapes_match(jax_shapes, module, expected_count):
    """Every tensor the JAX tree carries has the port's shape, and no port
    tensor is left over; the parameter count is ``expected_count``."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_shapes)
    carried = jax_variables_to_state_dict(zeros["params"], zeros.get("batch_stats", {}))
    state = module.state_dict()
    assert set(carried) == set(state)
    mismatched = [k for k in state if tuple(state[k].shape) != tuple(carried[k].shape)]
    assert not mismatched, mismatched
    count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jax_shapes["params"]))
    assert count == sum(p.numel() for p in module.parameters()) == expected_count


def test_av_slowfast_default_builder_carries_jax_full_width():
    # The default geometry: slow 8x224x224, fast 32x224x224, 128 x 80 audio.
    jax_model = jax_av.create_audio_visual_slowfast()
    x = [jnp.zeros((1, 8, 224, 224, 3)), jnp.zeros((1, 32, 224, 224, 3)),
         jnp.zeros((1, 128, 1, 80, 1))]
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), x, False))
    model = av.create_audio_visual_slowfast(device="meta")
    _shapes_match(shapes, model, 42321800)


def _folded_jax_bns(stats):
    """BN nodes of a batch_stats tree that JAX's fold_conv_bn marked folded:
    mean 0 and var 1 - eps."""
    if "mean" in stats:
        return int(not np.any(stats["mean"]) and np.allclose(stats["var"], 1 - 1e-5))
    return sum(_folded_jax_bns(child) for child in stats.values())


def test_av_slowfast_deploy_fold_matches_jax():
    jax_model, variables, model, forward = _av_pair()
    x = _av_inputs(seed=7)
    unfused = _run(model, x)
    deploy = convert_to_deployable_form(model, dtype=None)
    folded_out = _run(deploy, x)
    np.testing.assert_allclose(folded_out, unfused, rtol=0,
                               atol=FOLD_REL * np.abs(unfused).max())
    norms = sum(isinstance(m, BatchNorm) for m in model.modules())
    kept = [n for n, m in deploy.named_modules() if isinstance(m, BatchNorm)]
    # The acoustic stem's BN follows a ConvReduce3D: it stays, in eval mode.
    assert kept == ["blocks.0.multipathway_blocks.2.norm"]
    assert not any(m.training for m in deploy.modules())
    jax_folded = jax_fold_conv_bn(variables)
    assert _folded_jax_bns(variables["batch_stats"]) == 0
    assert norms - len(kept) == _folded_jax_bns(jax_folded["batch_stats"]) == 64
    np.testing.assert_allclose(folded_out, np.asarray(forward(jax_folded, _jax(x))), **TOL)


# --- the acoustic ResNet ----------------------------------------------------

def _acoustic_kwargs(builder):
    skip = {"model_num_class", "dropout_rate", "stem_dim_out", "head_pool_kernel_size"}
    return {k: p.default for k, p in inspect.signature(builder).parameters.items()
            if k not in skip and k != "device"}


def test_acoustic_resnet_matches_jax():
    jax_model = jax_resnet.create_resnet(**_acoustic_kwargs(jax_resnet.create_acoustic_resnet),
                                         **ACOUSTIC_NARROW)
    x = _clip(AUDIO_CLIP, 11)
    variables = _variables(jax_model, x, seed=12)
    ref = _apply(jax_model, variables, x, False)
    model = _load(resnet.create_resnet(**_acoustic_kwargs(resnet.create_acoustic_resnet),
                                       **ACOUSTIC_NARROW, device="cpu"), variables)
    np.testing.assert_allclose(_run(model, x), ref, **TOL)
    assert isinstance(model.blocks[0].conv, layers.ConvReduce3D) and model.blocks[0].pool is None
    kinds = [type(stage.res_blocks[0].branch2).__name__ for stage in model.blocks[1:5]]
    assert kinds == ["SeparableBottleneckBlock"] * 2 + ["BottleneckBlock"] * 2


def test_acoustic_resnet_default_builder_carries_jax_full_width():
    jax_model = jax_resnet.create_acoustic_resnet()
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 1, 80, 1)), False))
    _shapes_match(shapes, resnet.create_acoustic_resnet(device="meta"), 32746256)


# --- layers -----------------------------------------------------------------

@pytest.mark.parametrize("method", ["sum", "cat"])
def test_conv_reduce_3d_matches_jax(method):
    kw = dict(out_channels=6, kernel_size=((3, 1, 1), (1, 3, 3), (1, 1, 1)),
              stride=((1, 1, 1), None, (1, 1, 1)), padding=((1, 0, 0), (0, 1, 1), None),
              bias=(True, False, None), reduction_method=method)
    x = _clip((2, 4, 5, 6, 7), 20)
    jax_conv = jax_convolutions.ConvReduce3D(**kw)
    variables = _variables(jax_conv, x, seed=21)
    conv = _load(layers.ConvReduce3D(in_channels=4, **kw), variables)
    assert [c.bias is not None for c in conv.convs] == [True, False, True]
    out = _run(conv, x)
    assert out.shape == (2, 18 if method == "cat" else 6, 5, 6, 7)
    np.testing.assert_allclose(_channels_last(out), _apply(jax_conv, variables, x, False), **TOL)


def test_acoustic_stem_matches_jax():
    kw = dict(in_channels=1, out_channels=8, conv_kernel_size=(9, 1, 9), conv_stride=(1, 1, 3),
              conv_padding=(4, 0, 4), pool=None)
    x = _clip((2, 1, 16, 1, 20), 22)
    jax_module = jax_stem.create_acoustic_res_basic_stem(**kw)
    variables = _variables(jax_module, x, seed=23)
    module = _load(stem.create_acoustic_res_basic_stem(**kw, device="cpu"), variables)
    assert [c.kernel_size for c in module.conv.convs] == [(9, 1, 1), (1, 1, 9)]
    out = _run(module, x)
    assert out.shape == (2, 8, 16, 1, 7)
    np.testing.assert_allclose(_channels_last(out), _apply(jax_module, variables, x, False), **TOL)


def test_separable_bottleneck_matches_jax_branch_by_branch():
    kw = dict(dim_in=6, dim_inner=4, dim_out=8, conv_a_kernel_size=(3, 1, 1),
              conv_a_stride=(2, 1, 1), conv_a_padding=(1, 0, 0), conv_b_kernel_size=(3, 1, 3),
              conv_b_stride=(1, 1, 2), conv_b_padding=(1, 0, 1))
    x = _clip((2, 6, 8, 1, 10), 24)
    jax_block = jax_resnet.create_acoustic_bottleneck_block(**kw)
    variables = _variables(jax_block, x, seed=25)
    block = _load(resnet.create_acoustic_bottleneck_block(**kw, device="cpu"), variables)
    # JAX's conv_b_0 is the spatial (1, kh, kw) branch: the port's conv_b.0.
    assert variables["params"]["conv_b_0"]["kernel"].shape[:3] == (1, 1, 3)
    assert [c.kernel_size for c in block.conv_b] == [(1, 1, 3), (3, 1, 1)]
    np.testing.assert_allclose(_channels_last(_run(block, x)),
                               _apply(jax_block, variables, x, False), **TOL)
    # "cat" concatenates the branches for conv_c.
    with torch.no_grad():
        cat = resnet.SeparableBottleneckBlock(
            conv_a=block.conv_a, norm_a=block.norm_a, act_a=block.act_a,
            conv_b=list(block.conv_b), norm_b=list(block.norm_b), act_b=list(block.act_b),
            conv_c=torch.nn.Conv3d(8, 3, 1), reduce_method="cat").eval()
        assert cat(_torch(x)).shape == (2, 3, 4, 1, 5)


def _mean_fusion(shortcut, branch):
    return 0.5 * shortcut + 2.0 * branch


def test_res_block_branch_fusion_matches_jax():
    kw = dict(dim_in=4, dim_inner=3, dim_out=6, conv_a_kernel_size=(3, 1, 1),
              conv_a_stride=(1, 1, 1), conv_a_padding=(1, 0, 0), conv_b_kernel_size=(1, 3, 3),
              conv_b_stride=(1, 2, 2), conv_b_padding=(0, 1, 1))
    x = _clip((2, 4, 3, 6, 6), 26)
    jax_block = jax_resnet.create_res_block(**kw, bottleneck=jax_resnet.create_bottleneck_block,
                                            branch_fusion=_mean_fusion)
    variables = _variables(jax_block, x, seed=27)
    block = _load(resnet.create_res_block(**kw, bottleneck=resnet.create_bottleneck_block,
                                          branch_fusion=_mean_fusion, device="cpu"), variables)
    ref = _apply(jax_block, variables, x, False)
    np.testing.assert_allclose(_channels_last(_run(block, x)), ref, **TOL)
    # The default stays the sum.
    summed = _load(resnet.create_res_block(**kw, bottleneck=resnet.create_bottleneck_block,
                                           device="cpu"), variables)
    assert not np.allclose(_run(summed, x), _run(block, x))


@pytest.mark.parametrize("case", ["se", "no_se", "projection", "fusion"])
def test_audio_2d_se_block_and_its_fold_match_jax(case):
    kw = {"se": dict(dim_in=8, dim_out=8, use_se=True, se_reduction_ratio=4),
          "no_se": dict(dim_in=8, dim_out=8),
          "projection": dict(dim_in=4, dim_out=8, use_se=True, se_reduction_ratio=2,
                             conv_a_stride=2),
          "fusion": dict(dim_in=8, dim_out=8, use_se=True, se_reduction_ratio=4,
                         branch_fusion=_mean_fusion)}[case]
    x = _clip((2, kw["dim_in"], 9, 7), 28)
    jax_block = jax_se.create_audio_2d_squeeze_excitation_block(**kw)
    variables = _variables(jax_block, x, seed=29)
    block = _load(create_audio_2d_squeeze_excitation_block(**kw, device="cpu"), variables)
    assert (block.branch1_conv is not None) == (case == "projection")
    assert (block.se is not None) == (case != "no_se")
    ref = _apply(jax_block, variables, x, False)
    out = _run(block, x)
    np.testing.assert_allclose(_channels_last(out), ref, **TOL)
    # The fold: every BN into its Conv2d; JAX's folded variables agree.
    deploy = convert_to_deployable_form(block, dtype=None)
    assert deploy.norm_a is None and deploy.norm_b is None and deploy.branch1_norm is None
    folded = _run(deploy, x)
    np.testing.assert_allclose(folded, out, rtol=0, atol=FOLD_REL * np.abs(out).max())
    np.testing.assert_allclose(_channels_last(folded),
                               _apply(jax_block, jax_fold_conv_bn(variables), x, False), **TOL)


@pytest.mark.parametrize("kwargs", [dict(reduction_ratio=4), dict(reduction_ratio=None,
                                                                     reduced_planes=3)],
                         ids=["ratio", "planes"])
def test_squeeze_excitation_layer_2d_matches_jax(kwargs):
    x = _clip((2, 8, 5, 6), 30)
    jax_layer = jax_se.SqueezeAndExcitationLayer2D(in_planes=8, **kwargs)
    variables = _variables(jax_layer, x, seed=31, train_arg=False)
    layer = _load(SqueezeAndExcitationLayer2D(8, **kwargs), variables)
    assert layer.se.fc1.out_channels == (2 if "reduced_planes" not in kwargs else 3)
    np.testing.assert_allclose(_channels_last(_run(layer, x)),
                               _apply(jax_layer, variables, x), **TOL)
    with pytest.raises(ValueError):
        SqueezeAndExcitationLayer2D(8, reduction_ratio=4, reduced_planes=3)


def test_positional_encoding_matches_jax():
    x = _clip((2, 9, 12), 32)
    ref = np.asarray(jax_pe.PositionalEncoding(embed_dim=12, seq_len=16).apply({}, jnp.asarray(x)))
    module = layers.PositionalEncoding(12, seq_len=16, device="cpu")
    assert module.pe.dtype == torch.float32 and not module.state_dict()
    np.testing.assert_allclose(_run(module, x), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(module.pe[0].numpy(), jax_pe._sinusoidal_table(16, 12))
    with pytest.raises(ValueError):
        layers.PositionalEncoding(12, seq_len=8, device="cpu")(torch.zeros(1, 9, 12))


@pytest.mark.parametrize("name, args", [
    ("get_1d_sincos_pos_embed_from_grid", (16, np.arange(7, dtype=np.float32))),
    ("get_2d_sincos_pos_embed_from_grid", (16, np.stack(np.meshgrid(
        np.arange(5, dtype=np.float32), np.arange(5, dtype=np.float32))).reshape(2, 1, 5, 5))),
    ("get_2d_sincos_pos_embed", (24, 6, True)),
    ("get_3d_sincos_pos_embed", (32, 4, 3, True)),
])
def test_sincos_tables_equal_jax_to_the_bit(name, args):
    ours, ref = getattr(pe, name)(*args), getattr(jax_pe, name)(*args)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    assert getattr(layers, name) is getattr(pe, name)
