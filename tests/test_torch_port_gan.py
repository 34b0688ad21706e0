"""The PyTorch port's GAN modules (`models/gan.py`) and `models/unet_lib.py`'s
Encoder, Decoder and ResNet against the JAX package, on the CPU.

JAX params and stats go through `engine/from_jax` into the port; the
port's `state_dict` also goes through the JAX package's own
`torch_compat.snconv_family_to_flax`, an independent check of the SNConv
order. In train mode both sides run one power iteration and update the
BatchNorm statistics; held are the outputs, the updated u, v and BatchNorm
statistics, and the gradients of a fixed cotangent with respect to the
input and every weight. In eval mode, the outputs from the stored vectors.
Tolerance: rtol 1e-4 and atol 1e-5 of the reference's max |value| (conv
sums run in another order; an untrained spectral norm with unconverged u
and v scales the eval outputs far from 1); for a weight gradient, atol
1e-5 of the net's largest gradient. Inputs from numpy seeds.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.engine import torch_compat as TC
from spatialalignmentnetwork_tpu.engine.checkpoint import flatten_tree as jflatten
from spatialalignmentnetwork_tpu.models import gan as jgan
from spatialalignmentnetwork_tpu.models import unet_lib as junet_lib

from spatialalignmentnetwork_tpu_torch.engine import from_jax
from spatialalignmentnetwork_tpu_torch.models import gan as tgan
from spatialalignmentnetwork_tpu_torch.models import unet_lib as tunet_lib

torch.set_num_threads(2)
RTOL, ATOL_REL = 1e-4, 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, what, scale=None):
    """rtol RTOL, atol ATOL_REL of `scale` (default: max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale, err_msg=what)


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _entry(variables):
    out = {f"params/{k}": np.asarray(v) for k, v in jflatten(variables["params"]).items()}
    out.update({f"stats/{k}": np.asarray(v)
                for k, v in jflatten(variables.get("batch_stats", {})).items()})
    return out


def _randomize_bn(variables, seed):
    """Non-trivial BatchNorm scale, bias and running statistics, so eval
    mode reads them."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        if not isinstance(tree, dict):
            a = np.asarray(tree)
            if "BatchNorm" in path:
                if path.endswith(("scale", "var")):
                    return jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32))
                return jnp.asarray((0.1 * rng.standard_normal(a.shape)).astype(np.float32))
            return tree
        return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}

    return {coll: walk(tree, coll) for coll, tree in variables.items()}


def _jax_run(module, variables, x_nchw, cot, update, **call):
    """Output (NCHW), updated stats, and the gradients of sum(out * cot)
    with respect to the params and the input."""
    stats = variables.get("batch_stats", {})

    def f(params, x):
        if update:
            out, upd = module.apply({"params": params, "batch_stats": stats}, x,
                                    mutable=["batch_stats"], **call)
        else:
            out, upd = module.apply({"params": params, "batch_stats": stats}, x, **call), {}
        return jnp.sum(out * cot), (out, upd)

    (g_params, g_x), (out, upd) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], x_nchw)
    return out, upd.get("batch_stats", stats), g_params, g_x


def _port_run(module, x, cot, train):
    module.train(train)
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    out = module(xt)
    (out * torch.from_numpy(np.array(cot))).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _check_against_jax(jmodule, tmodule, entries, variables, x_nhwc, train, what,
                       call_jax=None):
    """Load `variables` into `tmodule`, run both on the same input and
    cotangent, and hold output, stats and gradients."""
    from_jax.load_from_jax(tmodule, _entry(variables), entries)
    call_jax = call_jax or (lambda m, v, x, c: _jax_run(m, v, x, c, train, train=train))
    x_nchw = _nchw(x_nhwc)
    out_j = jmodule.apply(variables, jnp.asarray(x_nchw), train=False)
    cot = _rand(np.shape(out_j), 99)
    out, stats, g_params, g_x = call_jax(jmodule, variables, jnp.asarray(x_nchw),
                                         jnp.asarray(cot))
    got_out, got_gx = _port_run(tmodule, x_nchw, cot, train)
    _close(got_out, out, f"{what} output")
    _close(got_gx, g_x, f"{what} d input")
    grads = from_jax.to_jax_entries(
        {k: p.grad for k, p in tmodule.named_parameters()},
        [e for e in entries if e[1].startswith("params/")])
    want = {f"params/{k}": v for k, v in jflatten(g_params).items()}
    assert grads.keys() == want.keys()
    # atol against the net's largest gradient: in train mode a conv bias
    # that a BatchNorm follows has an exact gradient of 0, and both
    # packages give rounding noise there
    net_max = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        _close(grads[k], v, f"{what} d {k}", net_max)
    sd = {k: v for k, v in tmodule.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    got_stats = from_jax.to_jax_entries(sd, entries)
    want_stats = {f"stats/{k}": v for k, v in jflatten(stats).items()}
    for k, v in want_stats.items():
        _close(got_stats[k], v, f"{what} {k}")
    return got_stats


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (2, 2)])
def test_spectral_conv_matches_jax(kernel, stride, train):
    """SpectralConv alone: one power iteration in train mode (u and v
    stored), the stored vectors in eval mode; sigma's gradient reaches the
    weight, not u and v."""
    jm = jgan.SpectralConv(6, (kernel, kernel), (stride, stride))
    x = _rand((2, 8, 8, 3), 0)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), update_stats=False)
    tm = tgan.SpectralConv(3, 6, kernel, stride)
    entries = [("weight_orig", "params/kernel", None, "conv"),
               ("bias", "params/bias", None, "same"),
               ("weight_u", "stats/u", None, "same"),
               ("weight_v", "stats/v", None, "same")]
    from_jax.load_from_jax(tm, _entry(variables), entries)
    stats = variables["batch_stats"]

    def f(params, x):
        out, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                            update_stats=train, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    cot = jnp.asarray(_rand((2, 8 // stride, 8 // stride, 6), 1))
    (g_params, g_x), (out, upd) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    got_out, got_gx = _port_run(tm, _nchw(x), _nchw(cot), train)
    _close(got_out, _nchw(out), "output")
    _close(got_gx, _nchw(g_x), "d input")
    _close(np.transpose(tm.weight_orig.grad.numpy(), (2, 3, 1, 0)), g_params["kernel"],
           "d kernel")
    _close(tm.bias.grad.numpy(), g_params["bias"], "d bias")
    _close(tm.weight_u.numpy(), upd["u"], "u")
    _close(tm.weight_v.numpy(), upd["v"], "v")
    if not train:
        np.testing.assert_array_equal(tm.weight_u.numpy(), np.asarray(stats["u"]))


@pytest.mark.parametrize("train", [True, False])
def test_netg_matches_jax(train):
    """NetG (layers (4, 8, 8): a nested level) through from_jax: output,
    BatchNorm statistics, u and v, and every gradient."""
    layers = (4, 8, 8)
    jm = jgan.NetG(out_chans=1, layers=layers)
    x = _rand((2, 16, 16, 1), 2)
    variables = jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(_nchw(x)), train=False)
    variables = _randomize_bn(dict(variables), 3)
    tm = tgan.NetG(layers=layers)
    _check_against_jax(jm, tm, from_jax.snconv_entries(tm), variables, x, train,
                       f"NetG train={train}")


@pytest.mark.parametrize("train", [True, False])
def test_netd_matches_jax(train):
    """NetD (blocks ((4,), (8, 8))) on 2-channel input: output, u and v,
    and every gradient."""
    blocks = ((4,), (8, 8))
    jm = jgan.NetD(blocks=blocks)
    x = _rand((3, 16, 16, 2), 4)
    variables = jm.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(_nchw(x)), train=False)
    tm = tgan.NetD(blocks=blocks)
    _check_against_jax(jm, tm, from_jax.snconv_entries(tm), dict(variables), x, train,
                       f"NetD train={train}")


def test_two_train_forwards_advance_u_and_v_twice():
    """net_G runs twice a GAN step: the second train-mode forward starts
    from the first's u and v, in both packages."""
    jm = jgan.NetG(out_chans=1, layers=(4, 8))
    x1, x2 = _rand((2, 1, 8, 8), 5), _rand((2, 1, 8, 8), 6)
    variables = jm.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x1), train=False)
    tm = tgan.NetG(layers=(4, 8))
    entries = from_jax.snconv_entries(tm)
    from_jax.load_from_jax(tm, _entry(variables), entries)
    stats = variables["batch_stats"]
    tm.train()
    for x in (x1, x2):
        out, upd = jm.apply({"params": variables["params"], "batch_stats": stats},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        _close(tm(torch.from_numpy(x)).detach().numpy(), out, "output")
    sd = {k: v for k, v in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    got = from_jax.to_jax_entries(sd, entries)
    for k, v in jflatten(stats).items():
        _close(got[f"stats/{k}"], v, k)


def test_port_state_dict_through_torch_compat():
    """The port's NetG and NetD state_dicts through the JAX package's
    ordered-zip converter give the entries from_jax writes, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    for tm, n_slots in ((tgan.NetG(layers=(4, 8, 8), generator=gen), None),
                        (tgan.NetD(blocks=((4,), (8, 8)), generator=gen), None)):
        entries = from_jax.snconv_entries(tm)
        slots = sorted({j.split("/")[1] for _, j, _, _ in entries},
                       key=lambda s: int(s.rsplit("_", 1)[1]))
        sd = {k: v.numpy() for k, v in tm.state_dict().items()
              if not k.endswith("num_batches_tracked")}
        params, stats = TC.snconv_family_to_flax(sd, slots)
        want = from_jax.to_jax_entries(
            {k: torch.from_numpy(v) for k, v in sd.items()}, entries)
        got = {**{f"params/{k}": v for k, v in params.items()},
               **{f"stats/{k}": v for k, v in stats.items()}}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fresh_build_is_seeded_and_xavier_normal():
    """A fresh NetG from a seeded generator: the same seed gives the same
    weights and vectors; u and v have unit norm; weight_orig's spread is
    xavier-normal's sqrt(2 / (fan_in + fan_out))."""
    a = tgan.NetG(layers=(8, 16), generator=torch.Generator().manual_seed(7))
    b = tgan.NetG(layers=(8, 16), generator=torch.Generator().manual_seed(7))
    c = tgan.NetG(layers=(8, 16), generator=torch.Generator().manual_seed(8))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith(("weight_orig", "weight_u", "weight_v")) and va.numel() > 1:
            assert not torch.equal(va, vc), k  # a 1-vector of norm 1 is +-1
    for name, m in a.named_modules():
        if isinstance(m, tgan.SpectralConv):
            np.testing.assert_allclose(float(m.weight_u.norm()), 1.0, rtol=1e-6)
            np.testing.assert_allclose(float(m.weight_v.norm()), 1.0, rtol=1e-6)
            o, i, kh, kw = m.weight_orig.shape
            std = np.sqrt(2.0 / ((i + o) * kh * kw))
            if m.weight_orig.numel() >= 1000:
                assert abs(float(m.weight_orig.detach().std()) / std - 1) < 0.1, name
            assert not m.bias.any()


@pytest.mark.parametrize("real,d_loss", [(True, True), (False, True), (False, False)])
def test_loss_gan_matches_jax(real, d_loss):
    pred = _rand((3, 1, 4, 4), 10, scale=2.0)
    want = jgan.loss_gan(jnp.asarray(pred), real=real, D_loss=d_loss)
    want_g = jax.grad(lambda p: jgan.loss_gan(p, real=real, D_loss=d_loss))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tgan.loss_gan(p, real=real, D_loss=d_loss)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-6)


def test_loss_gan_refuses_a_real_generator_loss():
    with pytest.raises(AssertionError, match="are you sure"):
        jgan.loss_gan(jnp.zeros(2), real=True, D_loss=False)
    with pytest.raises(ValueError, match="are you sure"):
        tgan.loss_gan(torch.zeros(2), real=True, D_loss=False)


def _conv_net_check(jm, tm, jax_inputs, port_inputs, what):
    """A norm-free conv net: params through from_jax.conv_entries, the
    output and the gradient of sum(out * cot) with respect to every
    weight."""
    variables = jm.init({"params": jax.random.PRNGKey(4)}, jax_inputs)
    entries = from_jax.conv_entries(tm)
    from_jax.load_from_jax(tm, _entry(variables), entries)
    out = jm.apply(variables, jax_inputs)
    cot = _rand(np.shape(out), 11)
    g = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jax_inputs) * cot))(
        variables["params"])
    got = tm(port_inputs)
    (got * torch.from_numpy(_nchw(cot))).sum().backward()
    _close(got.detach().numpy(), _nchw(out), f"{what} output")
    grads = from_jax.to_jax_entries({k: p.grad for k, p in tm.named_parameters()}, entries)
    for k, v in jflatten(g).items():
        _close(grads[f"params/{k}"], v, f"{what} d {k}")
    return out


def test_encoder_and_decoder_match_jax():
    """Encoder (3 levels) features, and a Decoder over them, through
    from_jax.conv_entries."""
    layers = (4, 6, 8)
    x = _rand((2, 16, 16, 2), 12)
    jenc = junet_lib.Encoder(layers=layers)
    tenc = tunet_lib.Encoder(2, layers)
    variables = jenc.init({"params": jax.random.PRNGKey(5)}, jnp.asarray(x))
    from_jax.load_from_jax(tenc, _entry(variables), from_jax.conv_entries(tenc))
    feats_j = jenc.apply(variables, jnp.asarray(x))
    feats_t = tenc(torch.from_numpy(_nchw(x)))
    assert len(feats_t) == len(feats_j) == 3
    for i, (a, b) in enumerate(zip(feats_t, feats_j)):
        _close(a.detach().numpy(), _nchw(b), f"encoder level {i}")
    bridges = [np.array(f) for f in feats_j]
    jdec = junet_lib.Decoder(out_chans=3, layers=(5, 6, 7), bridges=layers)
    tdec = tunet_lib.Decoder(3, (5, 6, 7), layers)
    _conv_net_check(jdec, tdec, [jnp.asarray(b) for b in bridges],
                    [torch.from_numpy(_nchw(b)) for b in bridges], "decoder")
    with pytest.raises(ValueError):
        tunet_lib.Decoder(3, (5, 6), layers)


@pytest.mark.parametrize("channels,res", [((4, 4, 4), False), ((4, 6, 6, 8), True),
                                          ((5, 5), True)])
def test_resnet_matches_jax(channels, res):
    """ResNet with and without the long shortcut, with channel changes (1x1
    shortcut convs) and without."""
    x = _rand((2, 12, 12, 3), 13)
    jm = junet_lib.ResNet(out_chans=2, channels=channels, res=res)
    tm = tunet_lib.ResNet(3, 2, channels, res)
    _conv_net_check(jm, tm, jnp.asarray(x), torch.from_numpy(_nchw(x)),
                    f"resnet {channels} res={res}")
