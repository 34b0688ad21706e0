"""The port's bf16 policy (`cfg.use_amp`) against the JAX package's, on
the CPU.

Per module (the norms, NormUnet, SensitivityModel, VarNet, the STN with
its LibUNet, SpectralConv, NetG, NetD): the JAX module built with
`dtype=jnp.bfloat16` against the port's under `set_compute_dtype(...,
torch.bfloat16)`, on the same weights (`engine/from_jax.py`) and the same
numpy inputs from a seed. Held:

  * the dtype at every cast site: forward hooks on the port's convs and
    norms, flax's captured intermediates on JAX's convs and BatchNorms
    (bf16 out), the modules' outputs (NormUnet complex64, the STN's
    offset and grid f32, NetG and NetD bf16, VarNet f32);
  * the outputs' (and, in train mode, the updated BatchNorm statistics')
    distance, max |port - JAX| / max |JAX|, at a bar per case of at most
    3x the largest distance over seeds 0-4 (`python3
    tests/test_torch_port_amp.py` prints them: XLA on the CPU keeps excess
    precision inside its fusions, while the port rounds after each op,
    so the bars are bf16-sized, not bit-exact);
  * two planted faults fail: a conv left in f32 (the dtype check) and an
    instance norm taking its statistics in bf16 (the norm bar, on inputs
    whose mean is far from 0).

The whole slice, on one tiny JAX CSModel with use_amp (32², 2 cascades,
4 channels; `net_R_s2d_train` 0, since the port leaves out the s2d
layout) saved and loaded by the port: `reconstruct`; one Rec and one
Mixed step's losses and every net's gradients, each net's within the
larger of 5e-2 relative L2 and 1.5x the JAX package's own bf16 distance
from its f32 step (the f32 step: the same state through nets cloned to
float32); the warp sees f32 alone; parameters and Adam state stay f32;
the checkpoint round trip both ways; None, GAN-Only (grad_accum 2), the
LOUPE learned-mask step and eval in bf16; `torch.cat`'s promotion of bf16
and f32 (forwardG's crossover relies on it) and `F.batch_norm` taking a
bf16 input with f32 weights.
"""

import argparse
import copy
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
import flax.linen as fnn

from spatialalignmentnetwork_tpu.engine.checkpoint import flatten_tree as jflatten
from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import GRAD_NETS
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel
from spatialalignmentnetwork_tpu.models import gan as jgan
from spatialalignmentnetwork_tpu.models import layers as jlayers
from spatialalignmentnetwork_tpu.models import unet as junet
from spatialalignmentnetwork_tpu.models import varnet as jvarnet
from spatialalignmentnetwork_tpu.models.stn import SpatialTransformer as JaxSTN

from spatialalignmentnetwork_tpu_torch.engine import csmodel as tcsmodel
from spatialalignmentnetwork_tpu_torch.engine import from_jax
from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
from spatialalignmentnetwork_tpu_torch.models import gan as tgan
from spatialalignmentnetwork_tpu_torch.models import layers as tlayers
from spatialalignmentnetwork_tpu_torch.models import unet as tunet
from spatialalignmentnetwork_tpu_torch.models import varnet as tvarnet
from spatialalignmentnetwork_tpu_torch.models.layers import set_compute_dtype
from spatialalignmentnetwork_tpu_torch.models.stn import SpatialTransformer
from spatialalignmentnetwork_tpu_torch.models.unet_lib import BatchNorm2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
try:
    import chip_smoke  # its dtype check of the nets inside a CSModel
finally:
    sys.path.remove(REPO)

torch.set_num_threads(2)
BF16, JBF16 = torch.bfloat16, jnp.bfloat16
SEEDS = range(5)
# the port's conv and norm modules, and JAX's conv and BatchNorm modules,
# whose outputs the dtype check reads
PORT_SITES = (tlayers.Conv2d, tlayers.ConvTranspose2d, tlayers.InstanceNorm, BatchNorm2d,
              tgan.SpectralConv)
JAX_SITES = ("Conv", "PairConv", "ConvTranspose", "BatchNorm", "SpectralConv")

# bars on the relative L2 distance ||port - JAX|| / ||JAX|| of the outputs,
# at most 3x the largest over SEEDS (`main` below prints them; measured:
# norms 3.16e-5 (BatchNorm-train), NormUnet 1.455e-2, SensitivityModel
# 4.08e-2, VarNet 2.39e-2, STN eval 3.50e-2 and train 2.91e-2,
# SpectralConv 3.16e-3 and 3.02e-3, NetG 6.43e-2 and 3.04e-2, NetD 1.08e-2
# and 1.03e-2: each about JAX's own bf16 distance from its f32, which
# `main` prints beside it); the norms share one bar
NORM_BAR = 9e-5
BARS = {
    "instance_norm": NORM_BAR, "group_norm_2": NORM_BAR, "BatchNorm-train": NORM_BAR,
    "BatchNorm-eval": NORM_BAR, "NormUnet": 4e-2, "SensitivityModel": 1.2e-1,
    "VarNet": 7e-2, "STN-eval": 1e-1, "STN-train": 8.5e-2, "SpectralConv-eval": 9e-3,
    "SpectralConv-train": 9e-3, "NetG-eval": 1.9e-1, "NetG-train": 9e-2,
    "NetD-eval": 3e-2, "NetD-train": 3e-2,
}
# the updated statistics after a train-mode forward, max |port - JAX| /
# max |JAX| of the worst array (measured 1.98e-5, 5.35e-3, 1.45e-7,
# 3.25e-3, 1.61e-7: u and v are f32 in both)
STATS_BARS = {"BatchNorm-train": 5e-5, "STN-train": 1.6e-2, "SpectralConv-train": 4e-7,
              "NetG-train": 9e-3, "NetD-train": 4e-7}


def _rand(shape, seed, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _nchw(x):
    return np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def _np(x):
    """A port or JAX array as numpy (bf16 read as f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == BF16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def dist(got, want) -> float:
    """max |got - want| / max |want| (the modulus for complex values)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.complex128) - want).max() / np.abs(want).max())


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||."""
    got, want = _np(got), _np(want)
    return float(np.linalg.norm((got.astype(np.complex128) - want).ravel())
                 / np.linalg.norm(want.ravel()))


def _entry(variables):
    out = {f"params/{k}": np.asarray(v) for k, v in jflatten(variables["params"]).items()}
    out.update({f"stats/{k}": np.asarray(v)
                for k, v in jflatten(variables.get("batch_stats", {})).items()})
    return out


def _randomize(variables, seed):
    """Numpy-seeded values for every leaf: kernels and biases N(0, 0.3),
    BatchNorm scales and variances in [0.5, 1.5], means N(0, 0.1); u and v
    as they are."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path.endswith(("/u", "/v")):
            return jnp.asarray(a)
        if path.endswith(("scale", "var")):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32))
        scale = 0.1 if path.endswith("mean") else 0.3
        return jnp.asarray((scale * rng.standard_normal(a.shape)).astype(np.float32))

    def walk(tree, path):
        if not isinstance(tree, dict):
            return leaf(path, tree)
        return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}

    return {coll: walk(dict(tree), coll) for coll, tree in variables.items()}


def _jax_apply(module, variables, *args, update=False, **kw):
    """(output, updated batch_stats, dtypes of its conv and BatchNorm
    outputs); `update`: batch_stats mutable."""
    mutable = ["intermediates"] + (["batch_stats"] if update else [])
    out, state = module.apply(
        variables, *args, mutable=mutable,
        capture_intermediates=lambda m, method: (type(m).__name__ in JAX_SITES
                                                  and method == "__call__"),
        **kw)
    dtypes = {str(leaf.dtype) for leaf in jax.tree_util.tree_leaves(state["intermediates"])}
    return out, state.get("batch_stats"), dtypes


def port_dtypes(module, fn):
    """fn()'s result and the output dtype of every conv and norm module of
    `module` that ran, as (module name, dtype)."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: seen.append((name, o.dtype)))
        for name, m in module.named_modules() if isinstance(m, PORT_SITES)]
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def dtype_faults(port_seen, jax_dtypes) -> list:
    """The cast sites whose dtype differs: a port conv or norm whose
    output is not bf16, or any JAX conv or BatchNorm output that is not."""
    faults = [f"port {name}: {dt}" for name, dt in port_seen if dt != BF16]
    faults += [f"jax: {dt}" for dt in jax_dtypes if dt != "bfloat16"]
    if not port_seen or not jax_dtypes:
        faults.append("no cast site ran")
    return faults


def _port_run(module, *args, train=False):
    module.train(train)
    with torch.no_grad():
        return port_dtypes(module, lambda: module(*(torch.from_numpy(np.asarray(a))
                                                    for a in args)))


def _stats_dist(module, entries, want_stats):
    """The largest distance of the port's BatchNorm statistics and u, v
    from flax's updated batch_stats."""
    sd = {k: v for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}
    got = from_jax.to_jax_entries(sd, entries)
    want = {f"stats/{k}": v for k, v in jflatten(want_stats).items()}
    assert got.keys() >= want.keys()
    return max(dist(got[k], v) for k, v in want.items())


# ------------------------------------------------------------ the cases
def _norm_case(name, seed):
    """A norm alone on bf16 inputs whose mean lies far from 0 (mean/std
    about 13), where statistics in bf16 lose the variance."""
    x = torch.from_numpy(_rand((2, 4, 12, 12), seed, 3.0, 40.0)).to(BF16)
    xj = jnp.asarray(_np(x), JBF16)
    out = {}
    if name == "instance_norm":
        got = tlayers.instance_norm(x)
        want = jnp.transpose(jlayers.instance_norm(jnp.transpose(xj, (0, 2, 3, 1)),
                                                   one_pass=False), (0, 3, 1, 2))
    elif name == "group_norm_2":
        g, mean, std = tunet.group_norm_2(x)
        jg, jmean, jstd = junet.group_norm_2(xj)
        got, want = torch.cat([g.flatten(), mean.flatten(), std.flatten()]), jnp.concatenate(
            [jg.ravel(), jmean.ravel(), jstd.ravel()])
    else:
        train = name == "BatchNorm-train"
        bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                           dtype=JBF16)
        xn = jnp.transpose(xj, (0, 2, 3, 1))
        v = _randomize(bn.init(jax.random.PRNGKey(0), xn), seed)
        want, stats, _ = _jax_apply(bn, v, xn, update=train)
        want = jnp.transpose(want, (0, 3, 1, 2))
        tm = set_compute_dtype(BatchNorm2d(4, eps=1e-5), BF16)
        entries = [("weight", "params/scale", None, "same"),
                   ("bias", "params/bias", None, "same"),
                   ("running_mean", "stats/mean", None, "same"),
                   ("running_var", "stats/var", None, "same")]
        from_jax.load_from_jax(tm, _entry(v), entries)
        tm.train(train)
        with torch.no_grad():
            got = tm(x)
        if train:
            out["stats"] = _stats_dist(tm, entries, stats)
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16", (got.dtype, want.dtype)
    out["out"] = rel_l2(got, want)
    return out


def _normunet_case(seed, ref32):
    z, ref = _complex((2, 1, 32, 32), seed), np.abs(_rand((2, 1, 32, 32), seed + 10)) * 4 + 2
    jn = junet.NormUnet(4, 2, use_ref=True, dtype=JBF16)
    v = jn.init(jax.random.PRNGKey(seed), jnp.asarray(z), jnp.asarray(ref))
    want, _, jdt = _jax_apply(jn, v, jnp.asarray(z), jnp.asarray(ref))
    want32 = ref32 and _jax_apply(jn.clone(dtype=jnp.float32), v, jnp.asarray(z),
                                  jnp.asarray(ref))[0]
    tn = set_compute_dtype(tunet.NormUnet(4, 2, use_ref=True), BF16)
    from_jax.load_from_jax(tn, _entry(v), from_jax._fastmri_unet("unet.", "params/Unet_0/", 2))
    got, seen = _port_run(tn, z, ref)
    return got, want, want32, seen, jdt, {}


def _sens_case(seed, ref32):
    k = _complex((2, 1, 32, 32), seed)
    js = jvarnet.SensitivityModel(4, 2, dtype=JBF16)
    v = js.init(jax.random.PRNGKey(seed), jnp.asarray(k), 8)
    want, _, jdt = _jax_apply(js, v, jnp.asarray(k), 8)
    want32 = ref32 and _jax_apply(js.clone(dtype=jnp.float32), v, jnp.asarray(k), 8)[0]
    ts = set_compute_dtype(tvarnet.SensitivityModel(4, 2), BF16)
    from_jax.load_from_jax(ts, _entry(v), from_jax._fastmri_unet(
        "norm_unet.unet.", "params/NormUnet_0/Unet_0/", 2))
    ts.eval()
    with torch.no_grad():
        got, seen = port_dtypes(ts, lambda: ts(torch.from_numpy(k), 8))
    return got, want, want32, seen, jdt, {}


VARNET = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)


def _varnet_case(seed, ref32):
    rng = np.random.default_rng(seed)
    pruned = rng.random(32) > 0.5
    pruned[:4] = pruned[-4:] = False
    mask = ~pruned
    k = _complex((2, 1, 32, 32), seed) * mask[None, None, None, :]
    ref = np.abs(_rand((2, 1, 32, 32), seed + 10))
    jnet = jvarnet.VarNet(use_ref=True, dtype=JBF16, **VARNET)
    args = (jnp.asarray(k), jnp.asarray(mask), jnp.asarray(ref))
    v = jax.jit(lambda key, k, m, r: jnet.init(key, k, m, r, 8))(jax.random.PRNGKey(seed), *args)
    want, _, jdt = _jax_apply(jnet, v, *args, 8)
    want32 = ref32 and _jax_apply(jnet.clone(dtype=jnp.float32), v, *args, 8)[0]
    tnet = set_compute_dtype(tvarnet.VarNet(use_ref=True, **VARNET), BF16)
    from_jax.load_varnet(tnet, _entry(v))
    tnet.eval()
    with torch.no_grad():
        got, seen = port_dtypes(tnet, lambda: tnet(
            torch.from_numpy(k), torch.from_numpy(mask), torch.from_numpy(ref), 8))
    return got, want, want32, seen, jdt, {}


def _stn_case(seed, train, ref32):
    layers = (4, 8, 8)
    mov, fix = np.abs(_rand((2, 1, 16, 16), seed)), np.abs(_rand((2, 1, 16, 16), seed + 10))
    jstn = JaxSTN(channels=1, feat=4, layers=layers, dtype=JBF16)
    v = jstn.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(mov), jnp.asarray(fix),
                  train=False)
    v = _randomize(v, seed)
    (joff, jgrid), stats, jdt = _jax_apply(jstn, v, jnp.asarray(mov), jnp.asarray(fix),
                                           update=train, train=train)
    want32 = ref32 and _jax_apply(jstn.clone(dtype=jnp.float32), v, jnp.asarray(mov),
                                  jnp.asarray(fix), update=train, train=train)[0]
    tstn = set_compute_dtype(SpatialTransformer(channels=1, feat=4, layers=layers), BF16)
    from_jax.load_stn(tstn, _entry(v))
    (toff, tgrid), seen = _port_run(tstn, mov, fix, train=train)
    extra = {"stats": _stats_dist(tstn, from_jax.stn_entries(tstn), stats)} if train else {}
    return (toff, tgrid), (joff, jgrid), want32, seen, jdt, extra


def _gan_case(kind, seed, train, ref32):
    if kind == "SpectralConv":
        jm, tm = jgan.SpectralConv(6, (3, 3), (1, 1), dtype=JBF16), tgan.SpectralConv(3, 6, 3, 1)
        x = _rand((2, 3, 8, 8), seed)
        v = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(_nhwc(x)),
                    update_stats=False)
        call = dict(update_stats=train)
        entries = [("weight_orig", "params/kernel", None, "conv"),
                   ("bias", "params/bias", None, "same"),
                   ("weight_u", "stats/u", None, "same"), ("weight_v", "stats/v", None, "same")]
        xj = jnp.asarray(_nhwc(x))
    elif kind == "NetG":
        jm, tm = jgan.NetG(out_chans=1, layers=(4, 8, 8), dtype=JBF16), tgan.NetG(layers=(4, 8, 8))
        x = np.abs(_rand((2, 1, 16, 16), seed))
        xj = jnp.asarray(x)
        v = jm.init({"params": jax.random.PRNGKey(seed)}, xj, train=False)
        call, entries = dict(train=train), from_jax.snconv_entries(tm)
    else:
        jm, tm = jgan.NetD(blocks=((4,), (8, 8)), dtype=JBF16), tgan.NetD(blocks=((4,), (8, 8)))
        x = np.abs(_rand((3, 2, 16, 16), seed))
        xj = jnp.asarray(x)
        v = jm.init({"params": jax.random.PRNGKey(seed)}, xj, train=False)
        call, entries = dict(train=train), from_jax.snconv_entries(tm)
    v = _randomize(dict(v), seed)
    want, stats, jdt = _jax_apply(jm, v, xj, update=train, **call)
    want32 = ref32 and _jax_apply(jm.clone(dtype=jnp.float32), v, xj, update=train, **call)[0]
    if kind == "SpectralConv":
        want = jnp.transpose(want, (0, 3, 1, 2))
        want32 = ref32 and jnp.transpose(want32, (0, 3, 1, 2))
    set_compute_dtype(tm, BF16)
    from_jax.load_from_jax(tm, _entry(v), entries)
    got, seen = _port_run(tm, x, train=train)
    extra = {"stats": _stats_dist(tm, entries, stats)} if train else {}
    return got, want, want32, seen, jdt, extra


def module_case(name, seed, ref32=False):
    """{'out': distance[, 'stats': ...]} of case `name`, after its dtype
    check (AssertionError on a fault); with `ref32` also 'jax_f32', JAX's
    own bf16 distance from the module in f32."""
    if name in ("instance_norm", "group_norm_2", "BatchNorm-train", "BatchNorm-eval"):
        return _norm_case(name, seed)
    kind, _, mode = name.partition("-")
    train = mode == "train"
    if kind == "NormUnet":
        got, want, want32, seen, jdt, extra = _normunet_case(seed, ref32)
    elif kind == "SensitivityModel":
        got, want, want32, seen, jdt, extra = _sens_case(seed, ref32)
    elif kind == "VarNet":
        got, want, want32, seen, jdt, extra = _varnet_case(seed, ref32)
    elif kind == "STN":
        got, want, want32, seen, jdt, extra = _stn_case(seed, train, ref32)
    else:
        got, want, want32, seen, jdt, extra = _gan_case(kind, seed, train, ref32)
    faults = dtype_faults(seen, jdt)
    assert not faults, f"{name}: {faults}"
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for g, w in zip(outs, wants):  # the modules' output dtypes: JAX's
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (name, g.dtype, w.dtype)
    out = {"out": max(rel_l2(g, w) for g, w in zip(outs, wants)), **extra}
    if ref32:
        wants32 = want32 if isinstance(want32, tuple) else (want32,)
        out["jax_f32"] = max(rel_l2(w, w32) for w, w32 in zip(wants, wants32))
    return out


@pytest.mark.parametrize("name", sorted(BARS))
def test_module_in_bf16_matches_jax(name):
    got = module_case(name, 0)
    assert got["out"] <= BARS[name], f"{name}: output {got['out']:.3g} > {BARS[name]}"
    if name in STATS_BARS:
        assert got["stats"] <= STATS_BARS[name], (
            f"{name}: statistics {got['stats']:.3g} > {STATS_BARS[name]}")


def test_planted_faults_fail(monkeypatch):
    """A conv left in f32 (the U-Net's first, whose input is the f32 group
    norm) fails the dtype check; an instance norm taking its statistics in
    bf16 fails its bar."""
    z, ref = _complex((2, 1, 32, 32), 0), np.abs(_rand((2, 1, 32, 32), 10)) * 4 + 2
    tn = set_compute_dtype(tunet.NormUnet(4, 2, use_ref=True), BF16)
    tn.unet.down_sample_layers[0].layers[0].compute_dtype = None
    _, seen = _port_run(tn, z, ref)
    assert dtype_faults(seen, {"bfloat16"}) == [
        "port unet.down_sample_layers.0.layers.0: torch.float32",
        "port unet.down_sample_layers.0.layers.1: torch.float32"]
    monkeypatch.setattr(tlayers, "stat_dtype", lambda dtype: dtype)
    err = _norm_case("instance_norm", 0)["out"]
    assert err > BARS["instance_norm"], err


def test_torch_promotes_as_jax_where_f32_meets_bf16():
    """torch.cat of f32 and bf16 is f32 (jnp.concatenate's promotion, which
    forwardG's crossover relies on before the warp); F.batch_norm takes a
    bf16 input with f32 weights on the CPU (the port's BatchNorm2d upcasts
    before it all the same)."""
    a, b = torch.ones(2, 3), torch.ones(2, 3, dtype=BF16)
    assert torch.cat([a, b]).dtype == torch.float32
    assert str(jnp.concatenate([jnp.ones((2, 3)), jnp.ones((2, 3), JBF16)]).dtype) == "float32"
    x = torch.from_numpy(_rand((2, 4, 6, 6), 0)).to(BF16)
    out = F.batch_norm(x, None, None, torch.ones(4), torch.zeros(4), True, 0.0, 1e-5)
    assert out.dtype == BF16


# ------------------------------------------------------------ the slice
SHAPE = 32
NETS = ("net_G", "net_D", "net_T", "net_R")
GRAD_L2 = 5e-2  # a net's gradient: the floor of its bar (PERF.md section 2)
GRAD_JAX_FACTOR = 1.5  # ... or this times JAX's own bf16 distance from f32
# at most 3x the largest over 5 input seeds (`main`): reconstruct 1.06e-2
# relative L2 (JAX's own bf16 distance from f32 1.00e-2); the step losses'
# worst |port - JAX| / max(|JAX|, 1e-2) 2.06e-2 (Mixed; Rec 4.31e-3);
# eval's metric_PSNR 5.0e-3 dB. The gradients read 0.28-0.34 relative L2
# for net_R (JAX's own 0.36-0.46), 0.22-0.24 for net_G (0.20-0.22),
# 0.14-0.15 for net_D (0.13-0.14), 0.030-0.045 for net_T (0.036-0.056)
RECON_BAR = 3e-2
LOSS_BAR = 6e-2
PSNR_BAR = 1.5e-2  # dB


def slice_cfg(reg, **extra):
    """The tiny configuration of tests/test_torch_port_gan_train.py at
    32², under use_amp (the JAX package's s2d train layout off)."""
    return Config(**{
        **dict(sparsity=0.25, lr=1e-4, shape=SHAPE, coils=1, reg=reg, mask="equispaced",
               weight_smooth=1000.0, weight_gan=0.1, weight_gan_sim=1.0, weight_sim=1.0,
               net_G_layers=(4, 8), net_D_blocks=((4,), (8,)), net_T_layers=(4, 8),
               net_R_cascades=2, net_R_chans=4, net_R_sens_chans=4, net_R_pools=1,
               net_R_sens_pools=1, use_amp=True, net_R_s2d_train=0),
        **extra,
    })


def _batch(seed, n=2):
    rng = np.random.default_rng(300 + seed)
    mk = lambda: (rng.random((n, 1, SHAPE, SHAPE))
                  + 1j * rng.random((n, 1, SHAPE, SHAPE))).astype(np.complex64)
    return mk(), mk()


def make_start(directory):
    """A tiny JAX CSModel under use_amp, its STN head non-zero so that the
    warp moves the reference, saved under `directory`; and a copy whose
    nets compute in f32. Returns (model, f32 copy, checkpoint path)."""
    jm = JaxCSModel(cfg=JaxConfig(**slice_cfg("Mixed").to_dict()), seed=0)
    assert jm.dtype == jnp.bfloat16
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(6)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jnp.asarray(np.array([0.04, -0.03], np.float32))
    path = os.path.join(directory, "start")
    jm.save(path)
    jm32 = copy.copy(jm)
    jm32._step_cache = {}
    for name in ("net_G", "net_D", "net_T", "net_R", "net_R_train"):
        setattr(jm32, name, getattr(jm, name).clone(dtype=jnp.float32))
    return jm, jm32, path


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    return make_start(str(tmp_path_factory.mktemp("amp")))


def _jax_grads(jm, regime, full, aux):
    """Step 0 of `regime` on the JAX model's state: its losses, and
    jax.grad of the G-phase loss for the regime's nets and, in Mixed, of
    the D-phase loss for net_D, as checkpoint entries."""
    state = jm.state
    env = jm._prepare(jnp.asarray(full), jnp.asarray(aux), state["pruned"])
    params, stats = state["params"], state["stats"]

    def fn(train_params, params_d):
        def loss_fn(tp):
            total, losses, imgs, new_stats = jm._regime_loss(
                {**params, **tp}, stats, env, regime)
            return total, (losses, imgs, new_stats)

        grads, (losses, imgs, new_stats) = jax.grad(loss_fn, has_aux=True)(train_params)
        if regime != "Mixed":
            return grads, losses
        loss_fn_d = jm._d_phase_loss_fn(imgs["img_aligned"], env["img_full_rss"],
                                        new_stats["net_D"])
        g_d, (lf, lr, _) = jax.grad(loss_fn_d, has_aux=True)(params_d)
        return {**grads, "net_D": g_d}, {**losses, "loss_gan_Dfake": lf, "loss_gan_Dreal": lr}

    grads, losses = jax.jit(fn)({k: params[k] for k in GRAD_NETS[regime]}, params["net_D"])
    grads = {name: {f"params/{k}": np.asarray(v, np.float32)
                    for k, v in jflatten(g).items()} for name, g in grads.items()}
    return grads, {k: float(v) for k, v in losses.items()}


# the nets each regime's step runs
STEP_NETS = {"None": ("net_R",), "Rec": ("net_T", "net_R"), "Mixed": NETS,
             "GAN-Only": ("net_T", "net_G", "net_D")}


def _port_step(path, regime, full, aux, **extra):
    """The port's model of checkpoint `path` after one step of `regime`:
    (model, losses, gradients as checkpoint entries, the dtypes the warp
    was given); every conv and norm of the nets the step runs is held to
    the cfg's compute dtype by chip_smoke.py's check (bf16 here)."""
    tm = CSModel(ckpt=path, cfg=slice_cfg(regime, **extra), device="cpu")
    warped = []
    warp = tcsmodel.warp

    def recording_warp(img, grid):
        warped.append((img.dtype, grid.dtype))
        return warp(img, grid)

    tcsmodel.warp = recording_warp
    try:
        tm.set_input(full, aux)
        with chip_smoke.net_dtypes(tm) as seen:
            tm.update()
    finally:
        tcsmodel.warp = warp
    chip_smoke.check_net_dtypes(seen, tm.dtype, STEP_NETS[regime], f"{regime} {extra}")
    grads = {}
    for name in NETS:
        params = dict(getattr(tm, name).named_parameters())
        if next(iter(params.values())).grad is not None:
            entries = [e for e in tm._entries(name) if e[1].startswith("params/")]
            grads[name] = from_jax.to_jax_entries(
                {k: p.grad for k, p in params.items()}, entries)
    return tm, tm.get_vis("scalars")["scalars"], grads, warped


def _net_l2(got, want):
    """Relative L2 distance of one net's gradient, all leaves at once."""
    keys = sorted(want)
    g = np.concatenate([np.ravel(got[k]) for k in keys])
    w = np.concatenate([np.ravel(want[k]) for k in keys])
    return rel_l2(g, w)


def loss_dist(got, want):
    """The worst |port - JAX| / max(|JAX|, 1e-2) over the losses."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    return max(abs(got[k] - w) / max(abs(w), 1e-2) for k, w in want.items())


def step_distances(start, regime, seed):
    """(losses' distance, {net: (port's gradient distance from JAX's bf16,
    JAX's bf16 distance from its f32)}) of step 0 of `regime`."""
    jm, jm32, path = start
    full, aux = _batch(seed)
    want, want_losses = _jax_grads(jm, regime, full, aux)
    want32, _ = _jax_grads(jm32, regime, full, aux)
    tm, got_losses, got, warped = _port_step(path, regime, full, aux)
    assert set(got) == set(want), (sorted(got), sorted(want))
    assert warped and set(warped) == {(torch.float32, torch.float32)}, warped
    return loss_dist(got_losses, want_losses), {
        name: (_net_l2(got[name], want[name]), _net_l2(want[name], want32[name]))
        for name in want}


@pytest.mark.parametrize("regime", ["Rec", "Mixed"])
def test_step_in_bf16_matches_jax(start, regime):
    """Step 0's losses and every net's gradients (net_D's from the D-phase
    in Mixed) against the JAX package's bf16 step; the warp gets f32."""
    losses, nets = step_distances(start, regime, 0)
    assert losses <= LOSS_BAR, f"{regime} losses {losses:.3g} > {LOSS_BAR}"
    for name, (err, jax_err) in nets.items():
        bar = max(GRAD_L2, GRAD_JAX_FACTOR * jax_err)
        assert err <= bar, (f"{regime} {name}: gradient {err:.3g} from JAX's bf16 > bar "
                            f"{bar:.3g} (JAX's own bf16 distance from f32 {jax_err:.3g})")


def recon_distance(start, seed):
    jm, _, path = start
    full, aux = _batch(seed, n=3)
    tm = CSModel(ckpt=path, device="cpu")
    with chip_smoke.net_dtypes(tm) as seen:
        got = tm.reconstruct(full, aux)
    chip_smoke.check_net_dtypes(seen, BF16, STEP_NETS["Rec"], "reconstruct")
    assert got.dtype == torch.float32 and tm.dtype == BF16
    return rel_l2(got, jm.reconstruct(full, aux))


def test_reconstruct_in_bf16_matches_jax(start):
    err = recon_distance(start, 0)
    assert err <= RECON_BAR, f"reconstruct {err:.3g} > {RECON_BAR}"


def psnr_distance(start, seed):
    """|port - JAX| of metric_PSNR (dB) of one volume through `test`."""
    jm, _, path = start
    full, aux = _batch(seed, n=4)
    tm = CSModel(ckpt=path, device="cpu").eval()
    tm.set_input(full, aux)
    with chip_smoke.net_dtypes(tm) as seen:
        got = -tm.test()
    chip_smoke.check_net_dtypes(seen, BF16, STEP_NETS["Rec"], "test")
    jm.eval()
    jm.set_input(full, aux)
    want = -jm.test()
    jm.train()
    assert all(v.dtype == torch.float32 for k, v in tm._aux.items()
               if k.startswith(("metric_", "loss_"))), {k: v.dtype for k, v in tm._aux.items()}
    return abs(got - want)


def test_eval_step_in_bf16_matches_jax(start):
    err = psnr_distance(start, 0)
    assert err <= PSNR_BAR, f"metric_PSNR {err:.3g} dB > {PSNR_BAR}"


def test_every_train_entry_runs_in_bf16_keeping_f32_state(start):
    """None, Rec, Mixed, GAN-Only at grad_accum 2 and the LOUPE learned
    Rec step, under use_amp: finite losses, the warp given f32, and
    parameters and Adam moments f32."""
    _, _, path = start
    full, aux = _batch(1, n=4)
    runs = (("None", {}), ("Rec", {}), ("Mixed", {}), ("GAN-Only", dict(grad_accum=2)),
            ("Rec", dict(mask="loupe", learn_mask=True)))
    for regime, extra in runs:
        label = f"{regime} {extra}"
        if "mask" in extra:  # a LOUPE model of the checkpoint's nets
            tm = CSModel(cfg=slice_cfg(regime, **extra), device="cpu")
            tm.load_entries({k: v for k, v in tcsmodel.ckpt_load(path).items()
                             if k in NETS})
            before = tm.net_mask.weight.detach().clone()
            tm.set_input(full, aux)
            with chip_smoke.net_dtypes(tm) as seen:
                tm.update()
            chip_smoke.check_net_dtypes(seen, BF16, STEP_NETS[regime], label)
            assert float((tm.net_mask.weight.detach() - before).abs().max()) > 0
            losses = tm.get_vis("scalars")["scalars"]
        else:
            tm, losses, _, warped = _port_step(path, regime, full, aux, **extra)
            assert set(warped) == {(torch.float32, torch.float32)}, (label, warped)
        assert losses and all(np.isfinite(v) for v in losses.values()), (label, losses)
        for name, opt in tm.opt.items():
            for p in getattr(tm, name).parameters():
                assert p.dtype == torch.float32, (label, name)
                for key in ("exp_avg", "exp_avg_sq"):
                    if p in opt.state:
                        assert opt.state[p][key].dtype == torch.float32, (label, name)


@pytest.mark.parametrize("use_amp,net,fault", [(True, "net_G", torch.float32),
                                               (False, "net_R", BF16)])
def test_a_net_in_the_other_dtype_fails_the_dtype_check(start, use_amp, net, fault):
    """The planted fault of the nets' dtype check (the whole-slice tests
    above, chip_smoke.py's phase 14): one net of a Mixed step left in the
    other precision, f32 under use_amp or bf16 without, must fail it."""
    _, _, path = start
    tm = CSModel(ckpt=path, cfg=slice_cfg("Mixed", use_amp=use_amp), device="cpu")
    assert tm.dtype == (BF16 if use_amp else torch.float32)
    set_compute_dtype(getattr(tm, net), fault)
    tm.set_input(*_batch(0))
    with chip_smoke.net_dtypes(tm) as seen:
        tm.update()
    chip_smoke.check_net_dtypes({s for s in seen if s[0] != net}, tm.dtype, (), "the rest")
    with pytest.raises(AssertionError, match=net):
        chip_smoke.check_net_dtypes(seen, tm.dtype, NETS, "fault")


def test_use_amp_checkpoints_go_both_ways(start, tmp_path):
    """The JAX checkpoint loads in the port (the fixture's models), and the
    port's, after a step with its Adam state, loads in the JAX package:
    the same parameters, f32, the cfg's use_amp, and reconstructions at
    the bar."""
    jm, _, path = start
    full, aux = _batch(2)
    tm, _, _, _ = _port_step(path, "Mixed", full, aux)
    out = str(tmp_path / "port")
    tm.save(out, with_opt=True)
    jm2 = JaxCSModel(ckpt=out)
    assert jm2.dtype == jnp.bfloat16 and bool(jm2.cfg.use_amp)
    for name in NETS:
        want = tm.checkpoint([name])[name]
        got = {f"{coll}/{k}": np.asarray(v)
               for coll, tree in (("params", jm2.state["params"][name]),
                                  ("stats", jm2.state["stats"].get(name, {})))
               for k, v in jflatten(tree).items()}
        assert got.keys() == want.keys(), name
        for k, v in want.items():
            assert got[k].dtype == np.float32, (name, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")
    mu = jflatten(jm2.state["opt"]["net_R"][0].mu)
    assert {np.asarray(v).dtype for v in mu.values()} == {np.dtype(np.float32)}
    full, aux = _batch(3, n=3)
    assert rel_l2(tm.reconstruct(full, aux), jm2.reconstruct(full, aux)) <= RECON_BAR


def test_eval_clis_agree_on_a_bf16_checkpoint(start, tmp_path, monkeypatch):
    """Both eval CLIs score the JAX package's use_amp checkpoint (its saved
    cfg puts each CLI's model in bf16; neither has a flag for it) on two
    h5 volumes of 3 and 5 slices, bucket 4: each volume's metric_PSNR
    within PSNR_BAR, the other scalars finite."""
    from spatialalignmentnetwork_tpu.engine import eval as jeval
    from spatialalignmentnetwork_tpu.utils import cache
    from spatialalignmentnetwork_tpu_torch.engine import eval as teval
    from conftest import write_h5_volume

    _, _, path = start
    rows = []
    for v, slices in enumerate((3, 5)):
        for proto, seed in (("T1", 2 * v), ("T2", 2 * v + 1)):
            write_h5_volume(str(tmp_path / f"p{v}_{proto}.h5"), proto,
                            shape=(slices, 36, 36), seed=seed)
        rows.append(f"p{v}_T1.h5,p{v}_T2.h5")
    csv = tmp_path / "pairs.csv"
    csv.write_text("\n".join(rows) + "\n")
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    out = {who: str(tmp_path / f"{who}.json") for who in ("jax", "port")}
    jeval.main(argparse.Namespace(
        resume=path, val=str(csv), crop=SHAPE, protocals=["T2", "T1"], aux_aug=-1.0,
        bucket=4, data_parallel=False, save=None, metric=out["jax"]))
    teval.main(teval.build_parser().parse_args([
        "--resume", path, "--val", str(csv), "--protocals", "T2", "T1", "--bucket", "4",
        "--device", "cpu", "--crop", str(SHAPE), "--metric", out["port"]]))
    vols = {}
    for who, metric in out.items():
        with open(metric) as f:
            vols[who] = json.load(f)["volumes"]
    assert len(vols["port"]) == len(vols["jax"]) == 2
    for i, (got, want) in enumerate(zip(vols["port"], vols["jax"])):
        assert set(got) == set(want) and np.isfinite(list(got.values())).all(), (i, got)
        err = abs(got["metric_PSNR"] - want["metric_PSNR"])
        assert err <= PSNR_BAR, f"volume {i}: metric_PSNR {err:.3g} dB > {PSNR_BAR}"


def main():
    """Print each case's distances over SEEDS (the measurement the bars
    come from), then the slice's."""
    for name in sorted(BARS):
        runs = [module_case(name, seed, ref32=True) for seed in SEEDS]
        keys = sorted(runs[0])
        print(name, {k: max(r[k] for r in runs) for k in keys},
              {k: [float(f"{r[k]:.3g}") for r in runs] for k in keys}, flush=True)
    start_ = make_start(tempfile.mkdtemp())
    jm, jm32, _ = start_
    print("reconstruct", [float(f"{recon_distance(start_, s):.3g}") for s in SEEDS],
          "JAX's own bf16 distance from f32",
          [float(f"{rel_l2(jm.reconstruct(*_batch(s, n=3)), jm32.reconstruct(*_batch(s, n=3))):.3g}")
           for s in SEEDS], flush=True)
    print("eval metric_PSNR dB", [float(f"{psnr_distance(start_, s):.3g}") for s in SEEDS],
          flush=True)
    for regime in ("Rec", "Mixed"):
        for seed in SEEDS:
            losses, nets = step_distances(start_, regime, seed)
            print(regime, seed, f"losses {losses:.3g}",
                  {n: tuple(float(f"{v:.3g}") for v in d) for n, d in nets.items()}, flush=True)


if __name__ == "__main__":
    sys.exit(main())
