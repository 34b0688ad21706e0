"""Random weights of a configuration, made on the device from the seed.

The scales are a frozen copy of `chip_smoke.py::random_entries` at commit
3f2e19a: conv kernels N(0, 1/fan_in), biases and BatchNorm means
N(0, 0.05^2), BatchNorm scales 1 + N(0, 0.1^2), BatchNorm variances and
each cascade's dc_weight U(0.5, 1.5), net_T's head kernel a twentieth of
its draw and its bias (0.0213, -0.0171), so that every sample lies off
the pixel grid; and each spectral-norm conv's u and v those of its power
iteration run to convergence (POWER_ITERS, in float64), as a trained
checkpoint holds them. `random_entries` left net_D at its fresh build;
here it is drawn as net_G is.

Two settings of net_R's heads are this benchmark's own, for the reason
net_T's head is scaled: a VarNet of random weights is chaotic (a
perturbation of 2^-11 in every conv moves a reconstruction by 5-25%, so
bf16 and the fp8 control could not be told apart), where a trained one
refines its input a little in each cascade and keeps its sensitivity
maps away from 0 (min |sens| 9.66e-3 trained, 1.3e-4 random: PERF.md).
So each cascade's last 1x1 conv is drawn at CASCADE_HEAD of its scale,
and the sensitivity net's last conv has the bias SENS_HEAD_BIAS (real,
imaginary). Every normal comes from one draw and every
uniform from another, on a `torch.Generator` of the card.

The benchmark draws the weights against its own copy of the nets
(`reference/nets.py`, built on the meta device for their shapes) and
hands the same state dicts to the program and to the reference.
"""

import torch

from reference import nets as ref_nets

POWER_ITERS = 50
HEAD_BIAS = (0.0213, -0.0171)
CASCADE_HEAD = 0.1
SENS_HEAD_BIAS = (4.0, 0.0)


def _plan(nets):
    """[(net, key, shape, how)] for every tensor of every net's state dict;
    how: ("kernel", fan_in) | "small" | "scale" | "unit" | "zero" | "power"."""
    plan = []
    for name, net in nets.items():
        for mname, m in net.named_modules():
            pre = f"{mname}." if mname else ""
            own = dict(m.named_parameters(recurse=False))
            own.update(dict(m.named_buffers(recurse=False)))
            for key, t in own.items():
                shape = tuple(t.shape)
                if isinstance(m, ref_nets.BatchNorm2d):
                    how = {"weight": "scale", "bias": "small", "running_mean": "small",
                           "running_var": "unit", "num_batches_tracked": "zero"}[key]
                elif key in ("weight", "weight_orig") and len(shape) == 4:
                    fan_in = (shape[0] if isinstance(m, ref_nets.ConvTranspose2d)
                              else shape[1]) * shape[2] * shape[3]
                    how = ("kernel", fan_in)
                elif key == "bias":
                    how = "small"
                elif key == "dc_weight":
                    how = "unit"
                elif key in ("weight_u", "weight_v"):
                    how = "power"
                else:
                    raise KeyError(f"no rule for {name}.{pre}{key}")
                plan.append((name, pre + key, shape, how))
    return plan


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def draw(model_cfg: dict, seed: int, device) -> dict:
    """{net: state dict} of the configuration's four nets, on `device`."""
    with torch.device("meta"):
        nets = ref_nets.build(model_cfg)
    plan = _plan(nets)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal_n = sum(_numel(s) for _, _, s, how in plan if how not in ("unit", "zero", "power"))
    power_n = sum(s[0] for _, key, s, how in plan if key.endswith("weight_u"))
    unit_n = sum(_numel(s) for _, _, s, how in plan if how == "unit")
    normals = torch.randn(normal_n + power_n, generator=gen, device=device)
    uniforms = torch.rand(unit_n, generator=gen, device=device)
    state = {name: {} for name in nets}
    pos_n = pos_u = 0
    for name, key, shape, how in plan:
        n = _numel(shape)
        if how == "zero":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        elif how == "unit":
            t = 0.5 + uniforms[pos_u: pos_u + n].view(shape)
            pos_u += n
        elif how == "power":
            continue
        else:
            z = normals[pos_n: pos_n + n].view(shape)
            pos_n += n
            if how == "small":
                t = 0.05 * z
            elif how == "scale":
                t = 1.0 + 0.1 * z
            else:
                t = z * (1.0 / how[1]) ** 0.5
        state[name][key] = t
    head = state["net_T"]
    head["head.weight"] = head["head.weight"] * 0.05
    head["head.bias"] = torch.tensor(HEAD_BIAS, device=device)
    last = f"up_conv.{model_cfg['net_R_pools'] - 1}.1."
    r = state["net_R"]
    r[f"sens_net.norm_unet.unet.{last}bias"] = torch.tensor(SENS_HEAD_BIAS, device=device)
    for c in range(model_cfg["net_R_cascades"]):
        for k in ("weight", "bias"):
            r[f"cascades.{c}.model.unet.{last}{k}"] = r[f"cascades.{c}.model.unet.{last}{k}"] * CASCADE_HEAD
    _converge(plan, state, normals[pos_n:])
    # keep each net's keys in its state dict's order
    return {name: {k: state[name][k].contiguous() for k in nets[name].state_dict()}
            for name in nets}


def _converge(plan, state, starts):
    """Each spectral-norm conv's u and v from its power iteration, run
    POWER_ITERS times in float64 from a normal start."""
    pos = 0
    for name, key, shape, _ in plan:
        if not key.endswith("weight_u"):
            continue
        conv = key[: -len("weight_u")]
        w = state[name][conv + "weight_orig"].double()
        w = w.reshape(w.shape[0], -1)
        u = starts[pos: pos + shape[0]].double()
        pos += shape[0]
        for _ in range(POWER_ITERS):
            v = w.t() @ u
            v = v / torch.linalg.vector_norm(v)
            u = w @ v
            u = u / torch.linalg.vector_norm(u)
        state[name][conv + "weight_u"] = u.float()
        state[name][conv + "weight_v"] = v.float()
