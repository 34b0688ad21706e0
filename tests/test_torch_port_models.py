"""The PyTorch port's networks against the JAX package, on the CPU.

Weights go both ways: JAX params/stats -> `engine/from_jax` -> the port,
and the port's `state_dict` -> the JAX package's own `torch_compat`
converters -> the JAX modules, an independent check of the names and
layouts. Small widths, inputs from numpy seeds. Tolerances: layer
functions atol 1e-5; modules rtol 1e-3, atol 1e-4 (the bar of
tests/test_torch_parity.py: conv sums run in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.engine import torch_compat as TC
from spatialalignmentnetwork_tpu.engine.checkpoint import flatten_tree as jflatten
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel
from spatialalignmentnetwork_tpu.models import layers as jlayers
from spatialalignmentnetwork_tpu.models import unet as junet
from spatialalignmentnetwork_tpu.models import varnet as jvarnet
from spatialalignmentnetwork_tpu.models.stn import SpatialTransformer as JaxSTN
from spatialalignmentnetwork_tpu.models.unet_lib import LibUNet as JaxLibUNet

from spatialalignmentnetwork_tpu_torch.engine import from_jax
from spatialalignmentnetwork_tpu_torch.models import layers as tlayers
from spatialalignmentnetwork_tpu_torch.models import unet as tunet
from spatialalignmentnetwork_tpu_torch.models import varnet as tvarnet
from spatialalignmentnetwork_tpu_torch.models.stn import SpatialTransformer
from spatialalignmentnetwork_tpu_torch.models.unet_lib import LibUNet

torch.set_num_threads(2)
OPS = dict(atol=1e-5)
MODULES = dict(rtol=1e-3, atol=1e-4)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _entry(params, stats=None):
    """Nested flax params (+ batch_stats) -> one checkpoint entry, as
    CSModel.save writes it: {'params/...': array, 'stats/...': array}."""
    entry = {f"params/{k}": v for k, v in jflatten(params).items()}
    if stats:
        entry.update({f"stats/{k}": v for k, v in jflatten(stats).items()})
    return entry


def _randomize(tree, seed, positive=()):
    """Numpy-seeded values for every leaf of a flax tree (leaves whose path
    ends in one of `positive` are made positive, e.g. BN variances)."""
    flat = jflatten(tree)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        a = rng.standard_normal(v.shape).astype(np.float32) * 0.3
        if k.endswith(positive):
            a = np.abs(a) + 0.5
        out[k] = a
    return JaxCSModel._merge_like(tree, out)


def test_layer_functions_match_jax():
    x = _rand((2, 3, 20, 12), 0) * 5 + 3
    np.testing.assert_allclose(
        tlayers.instance_norm(torch.from_numpy(x)).numpy(),
        _nchw(jlayers.instance_norm(_nhwc(x), one_pass=False)), **OPS,
    )
    np.testing.assert_allclose(
        tlayers.upsample_nearest2(torch.from_numpy(x)).numpy(),
        _nchw(jlayers.upsample_nearest2(_nhwc(x))), **OPS,
    )
    np.testing.assert_allclose(
        tlayers.avg_pool2(torch.from_numpy(x)).numpy(),
        _nchw(jlayers.avg_pool2(_nhwc(x))), **OPS,
    )
    g = _rand((2, 4, 20, 12), 1) * 3 + 1
    g[1] = 2.0  # a zero-variance sample takes the std guard
    got = tunet.group_norm_2(torch.from_numpy(g))
    want = junet.group_norm_2(jnp.asarray(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPS)
    p, sizes = tunet.pad_to_16(torch.from_numpy(x))
    jp, jsizes = junet.pad_to_16(jnp.asarray(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert sizes == jsizes
    np.testing.assert_array_equal(tunet.unpad_16(p, *sizes).numpy(), x)
    for width, num_low in ((16, 3), (32, 8), (320, 25)):
        np.testing.assert_array_equal(
            tvarnet.acs_mask(width, num_low).numpy(),
            np.asarray(jvarnet.acs_mask(width, num_low)),
        )


def test_libunet_and_stn_from_jax_match():
    layers = (4, 8, 8)
    x = _rand((2, 2, 16, 16), 2)
    jnet = JaxLibUNet(out_chans=3, layers=layers)
    v = jnet.init({"params": jax.random.PRNGKey(0)}, _nhwc(x), train=False)
    params = _randomize(v["params"], 3)
    stats = _randomize(v["batch_stats"], 4, positive=("var",))
    want = _nchw(jnet.apply({"params": params, "batch_stats": stats},
                            _nhwc(x), train=False))
    # LibUNet alone: the STN's entries, its last conv numbered in the
    # LibUNet instead of taken for the STN's head
    tnet = LibUNet(2, 3, layers).eval()
    conv_count = sum(isinstance(m, torch.nn.Conv2d) for m in tnet.modules())
    entries = [
        (t, j if not j.startswith("params/Conv_0/")
         else j.replace("params/Conv_0/", f"params/LibUNet_0/Conv_{conv_count - 1}/"),
         c, k)
        for t, j, c, k in from_jax.stn_entries(tnet)
    ]
    entry = _entry({"LibUNet_0": params}, {"LibUNet_0": stats})
    from_jax.load_from_jax(tnet, entry, entries)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MODULES)

    # the whole STN, head non-zero so the grid moves
    jstn = JaxSTN(channels=1, feat=4, layers=layers)
    mov, fix = _rand((2, 1, 16, 16), 5), _rand((2, 1, 16, 16), 6)
    v = jstn.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(mov),
                  jnp.asarray(fix), train=False)
    params = _randomize(v["params"], 7)
    stats = _randomize(v["batch_stats"], 8, positive=("var",))
    joff, jgrid = jstn.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(mov), jnp.asarray(fix), train=False)
    tstn = SpatialTransformer(channels=1, feat=4, layers=layers).eval()
    from_jax.load_stn(tstn, _entry(params, stats))
    with torch.no_grad():
        toff, tgrid = tstn(torch.from_numpy(mov), torch.from_numpy(fix))
    assert toff.dtype == tgrid.dtype == torch.float32
    np.testing.assert_allclose(toff.numpy(), np.asarray(joff), **MODULES)
    np.testing.assert_allclose(tgrid.numpy(), np.asarray(jgrid), **MODULES)


def test_stn_train_forward_updates_batch_stats_like_flax():
    """One train-mode forward: the port's BatchNorm updates its running
    statistics as flax's BatchNorm(momentum=0.9) does in the JAX package,
    with the biased batch variance (torch's own BatchNorm2d uses the
    unbiased one, off by a factor n / (n - 1) of the batch term). rtol
    1e-5; atol 1e-6 for the means of O(1) activations, which carry the
    convs' f32 sum order at 1e-7 to 1e-6."""
    layers = (4, 8, 8)
    mov, fix = np.abs(_rand((2, 1, 16, 16), 11)), np.abs(_rand((2, 1, 16, 16), 12))
    jstn = JaxSTN(channels=1, feat=4, layers=layers)
    v = jstn.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(mov),
                  jnp.asarray(fix), train=False)
    params = _randomize(v["params"], 13)
    stats = _randomize(v["batch_stats"], 14, positive=("var",))
    (joff, _), upd = jstn.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(mov), jnp.asarray(fix), train=True,
                                mutable=["batch_stats"])
    tstn = SpatialTransformer(channels=1, feat=4, layers=layers)
    from_jax.load_stn(tstn, _entry(params, stats))
    tstn.train()
    toff, _ = tstn(torch.from_numpy(mov), torch.from_numpy(fix))
    np.testing.assert_allclose(toff.detach().numpy(), np.asarray(joff), **MODULES)
    want = {f"stats/{k}": np.asarray(a) for k, a in jflatten(upd["batch_stats"]).items()}
    sd = tstn.state_dict()
    checked = 0
    for tkey, jkey, _, _ in from_jax.stn_entries(tstn):
        if jkey.startswith("stats/"):
            np.testing.assert_allclose(sd[tkey].numpy(), want[jkey], rtol=1e-5,
                                       atol=1e-6, err_msg=jkey)
            checked += 1
    assert checked == len(want)


def test_stn_state_dict_through_torch_compat_matches():
    layers = (4, 8, 8)
    torch.manual_seed(0)
    tstn = SpatialTransformer(channels=1, feat=4, layers=layers)
    gen = torch.Generator().manual_seed(1)
    for m in tstn.modules():  # move BN stats off their init
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    torch.nn.init.normal_(tstn.head.weight, std=0.1, generator=gen)
    tstn.eval()
    mov, fix = _rand((2, 1, 16, 16), 9), _rand((2, 1, 16, 16), 10)
    with torch.no_grad():
        toff, _ = tstn(torch.from_numpy(mov), torch.from_numpy(fix))
    jstn = JaxSTN(channels=1, feat=4, layers=layers)
    v = jstn.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(mov),
                  jnp.asarray(fix), train=False)
    sd = {k: t.numpy() for k, t in tstn.state_dict().items()}
    p, s = TC.stn_to_flax(sd, jflatten(v["params"]).keys())
    params = JaxCSModel._merge_like(v["params"], p)
    stats = JaxCSModel._merge_like(v["batch_stats"], s)
    joff, _ = jstn.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(mov), jnp.asarray(fix), train=False)
    np.testing.assert_allclose(toff.numpy(), np.asarray(joff), **MODULES)


def test_unet_and_normunet_from_jax_match():
    x = _rand((2, 3, 24, 24), 11)
    jnet = junet.Unet(out_chans=2, chans=4, num_pool_layers=2)
    v = jnet.init(jax.random.PRNGKey(0), _nhwc(x))
    want = _nchw(jnet.apply(v, _nhwc(x)))
    tnet = tunet.Unet(3, 2, chans=4, num_pool_layers=2)
    entries = from_jax._fastmri_unet("", "params/", 2)
    from_jax.load_from_jax(tnet, _entry(v["params"]), entries)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MODULES)

    # odd size: the decoder's reflect-pad branch
    xo = _rand((1, 3, 21, 19), 12)
    with torch.no_grad():
        got = tnet(torch.from_numpy(xo)).numpy()
    np.testing.assert_allclose(got, _nchw(jnet.apply(v, _nhwc(xo))), **MODULES)

    # NormUnet with a raw (not prenormalized) ref channel
    z = _complex((2, 1, 20, 20), 13)
    ref = np.abs(_rand((2, 1, 20, 20), 14)) * 4 + 2
    jn = junet.NormUnet(4, 2, use_ref=True)
    v = jn.init(jax.random.PRNGKey(1), jnp.asarray(z), jnp.asarray(ref))
    want = np.asarray(jn.apply(v, jnp.asarray(z), jnp.asarray(ref)))
    tn = tunet.NormUnet(4, 2, use_ref=True)
    from_jax.load_from_jax(
        tn, _entry(v["params"]),
        from_jax._fastmri_unet("unet.", "params/Unet_0/", 2),
    )
    with torch.no_grad():
        got = tn(torch.from_numpy(z), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got, want, **MODULES)


def _varnet_inputs(coils, size=32, n=2):
    rng = np.random.default_rng(15)
    k = _complex((n, coils, size, size), 16)
    pruned = rng.random(size) > 0.5
    pruned[:4] = False
    pruned[-4:] = False
    mask = ~pruned
    k = k * mask[None, None, None, :]
    ref = np.abs(_rand((n, coils, size, size), 17))
    return k, mask, ref, 8


VARNET = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)


def _jit_init(net, key, k, mask, ref, num_low):
    return jax.jit(lambda key, k, m, r: net.init(key, k, m, r, num_low))(
        key, jnp.asarray(k), jnp.asarray(mask), jnp.asarray(ref))


def _jit_apply(net, params, k, mask, ref, num_low):
    return np.asarray(jax.jit(
        lambda p, k, m, r: net.apply({"params": p}, k, m, r, num_low)
    )(params, jnp.asarray(k), jnp.asarray(mask), jnp.asarray(ref)))


@pytest.mark.parametrize("coils", [1, 2])
def test_varnet_from_jax_matches(coils):
    k, mask, ref, num_low = _varnet_inputs(coils)
    jnet = jvarnet.VarNet(use_ref=True, **VARNET)
    v = _jit_init(jnet, jax.random.PRNGKey(coils), k, mask, ref, num_low)
    params = _randomize(v["params"], 18)  # dc_weight off its init of 1
    want = _jit_apply(jnet, params, k, mask, ref, num_low)
    tnet = tvarnet.VarNet(use_ref=True, **VARNET)
    from_jax.load_varnet(tnet, _entry(params))
    with torch.no_grad():
        got = tnet(torch.from_numpy(k), torch.from_numpy(mask),
                   torch.from_numpy(ref), num_low).numpy()
    assert got.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(got, want, **MODULES)


def test_varnet_state_dict_through_torch_compat_matches():
    k, mask, ref, num_low = _varnet_inputs(1)
    torch.manual_seed(3)
    tnet = tvarnet.VarNet(use_ref=True, **VARNET)
    with torch.no_grad():
        for c, cascade in enumerate(tnet.cascades):
            cascade.dc_weight.fill_(0.5 + c)
        got = tnet(torch.from_numpy(k), torch.from_numpy(mask),
                   torch.from_numpy(ref), num_low).numpy()
    sd = {k_: t.numpy() for k_, t in tnet.state_dict().items()}
    flat = TC.varnet_to_flax(sd, num_cascades=2, sens_pools=2, pools=2)
    jnet = jvarnet.VarNet(use_ref=True, **VARNET)
    v = _jit_init(jnet, jax.random.PRNGKey(0), k, mask, ref, num_low)
    params = JaxCSModel._merge_like(v["params"], flat)
    want = _jit_apply(jnet, params, k, mask, ref, num_low)
    np.testing.assert_allclose(got, want, **MODULES)


def test_from_jax_refuses_mismatched_entries():
    tnet = tvarnet.VarNet(use_ref=True, **VARNET)
    entries = from_jax.varnet_entries(2, 2, 2)
    entry = {}
    for tkey, jkey, cascade, kind in entries:
        shape = from_jax.to_jax_layout_shape(tnet.state_dict()[tkey].shape, kind)
        entry[jkey] = np.zeros((2, *shape) if cascade is not None else shape,
                               np.float32)
    from_jax.load_varnet(tnet, entry)
    with pytest.raises(KeyError):
        from_jax.load_varnet(tnet, {**entry, "params/Extra_0/kernel": np.zeros(1)})
    missing = dict(entry)
    missing.pop(entries[0][1])
    with pytest.raises(KeyError):
        from_jax.load_varnet(tnet, missing)
