"""JAX (flax) params → the port's `state_dict`.

The port's parameters carry the reference checkpoint's names and layouts, so
this is the inverse of the JAX package's `convert/torch_import.py`
`import_network`: each port key is resolved against the flax tree with the
same rules (`list.N` → `list_N`, a ConvLayer's Sequential index is skipped or
becomes `layerN`, `activate`/`activation` is skipped, a fused activation's
`bias` is flax's `act_bias`), and each array is laid out as the port holds it:

    conv HWIO                  → OIHW
    modulated conv HWIO        → (1, O, I, k, k)
    linear (in, out)           → (out, in), with final_linear's input
                                 features reordered from (H, W, C) to (C, H, W)
    constant input (1, H, W, C) → (1, C, H, W)

The StyleGAN2 generators (`StyleGAN2OCRGenerator`, the square
`StyleGAN2Generator`) take the general rules: the reference's
`style_mlp.N` (N ≥ 1, after the parameter-free NormStyleCode) is flax's
`style_mlp_{N-1}`.
SRVGGNetCompact's Real-ESRGAN `body.N` keys map to flax's `body_i`,
`prelu_i` and `conv_last` first (the JAX importer's rule, inverted).
RRDBNet's `body.i.rdbK.convJ.weight` becomes flax's `body_i/rdbK/convJ/kernel`
(flax's Conv names its weight `kernel`). StyleGAN2Discriminator's
`final_linear.0` is flax's `final_linear_0`, its input features reordered
like GFPGAN's `final_linear`. VGG's torchvision `features.N` keys map to
flax's `conv{block}_{i}` (`vgg_state_dict_from_jax`). The VGG-style and
UNet-SN discriminators take flax's `params` and `batch_stats`
(`discriminator_state_dict_from_jax`), and a QAT training state becomes
the part of the port's checkpoint that the SR engine reads
(`qat_checkpoint_from_jax`). The ten char discriminators, which JAX holds
as one `FacialComponentDiscriminator` tree with a leading axis of 10
(`params_dc`), become the port's grouped module
(`stacked_state_dict_from_jax`), and IResNet's FoldedBN scale/shift pairs
become frozen BatchNorms (`iresnet_state_dict_from_jax`). The HiFaceGAN
nets take the general rules, with an affine InstanceNorm's `weight` as
flax's `scale`; BasicSR's `fc` and the other phases' `to_rgbs` and `ups`,
which flax does not build, keep the port net's values
(`hifacegan_state_dict_from_jax`). InceptionV3's modules have flax's names,
with a conv's weight as `conv/kernel` and a BatchNorm's weight and running
statistics as `bn/scale`, `bn/mean` and `bn/var`
(`inception_state_dict_from_jax`).

Strict both ways: every port key must resolve and every flax leaf be used.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _resolve(tree: Dict, tokens: List[str]) -> Optional[Tuple[str, ...]]:
    path: List[str] = []
    node = tree
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if i == len(tokens) - 1:
            if tok in node and not isinstance(node[tok], dict):
                return tuple(path + [tok])
            if tok == "bias" and "act_bias" in node:
                return tuple(path + ["act_bias"])
            if tok == "weight" and "kernel" in node:  # a flax nn.Conv
                return tuple(path + ["kernel"])
            return None
        merged = f"{tok}_{tokens[i + 1]}"
        if isinstance(node.get(merged), dict):
            path.append(merged)
            node = node[merged]
            i += 2
            continue
        if isinstance(node.get(tok), dict):
            path.append(tok)
            node = node[tok]
            i += 1
            continue
        if tok.isdigit():
            if isinstance(node.get(f"layer{tok}"), dict):
                path.append(f"layer{tok}")
                node = node[f"layer{tok}"]
            i += 1  # a bare Sequential index (ConvLayer) is skipped
            continue
        if tok in ("activate", "activation"):
            i += 1
            continue
        return None
    return None


def _leaves(tree: Dict, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _flatten_fixes(net) -> Dict[str, Tuple[int, int, int]]:
    """Linears fed by a flattened feature map: key prefix → (C, H, W)."""
    if type(net).__name__ in ("GFPGANv1OCR", "GFPGANv1"):
        c4 = net.final_conv[0].weight.shape[0]
        return {"final_linear.": (c4, 4, 4 * net.ratio)}
    if type(net).__name__ == "StyleGAN2Discriminator":
        c4 = net.final_conv[0].weight.shape[0]
        return {"final_linear.0.": (c4, 4, 4 * net.ratio)}
    return {}


def _flax_key(net, key: str) -> str:
    """The port key rewritten into the flax tree's spelling."""
    if type(net).__name__ == "SRVGGNetCompact":
        # Real-ESRGAN's body.N: conv i at 2i, its PReLU at 2i+1, conv_last
        # at 2(num_conv+1); flax names them body_i, prelu_i, conv_last
        idx, leaf = key.split(".")[1:]
        i = int(idx)
        if i == 2 * (net.num_conv + 1):
            name = "conv_last"
        elif i % 2:
            return f"prelu_{i // 2}"
        else:
            name = f"body_{i // 2}"
        return f"{name}.{'kernel' if leaf == 'weight' else leaf}"
    if type(net).__name__ == "RRDBNet":
        # flax's nn.Conv names the weight `kernel`; body.i → body_i
        return re.sub(r"\.weight$", ".kernel", key)
    return re.sub(r"style_mlp\.(\d+)",
                  lambda m: f"style_mlp_{int(m.group(1)) - 1}", key)


def _fit(key: str, a: np.ndarray, shape: Tuple[int, ...],
         flat_chw: Optional[Tuple[int, int, int]]) -> np.ndarray:
    if key.endswith("constant_input.weight"):
        a = a.transpose(0, 3, 1, 2)
    elif a.ndim == 4:  # HWIO → OIHW (a modulated weight adds a leading 1)
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:  # (in, out) → (out, in)
        a = a.T
        if flat_chw is not None:
            c, h, w = flat_chw
            a = a.reshape(a.shape[0], h, w, c).transpose(0, 3, 1, 2)
    a = np.ascontiguousarray(a)
    if a.size != int(np.prod(shape)):
        raise ValueError(f"{key}: flax array of {a.size} values cannot fill "
                         f"the port's {tuple(shape)}")
    return a.reshape(shape)


# RetinaFace: the reference's Sequential indices → flax's module names (the
# `_RULES` of the JAX package's convert/retinaface_import.py, inverted, plus
# the ResNet bodies' `layerL.B` → `layerL_B`)
_RETINAFACE_RULES = [
    (r"^fpn\.(output\d|merge\d)\.0\.", r"fpn.\1_conv."),
    (r"^fpn\.(output\d|merge\d)\.1\.", r"fpn.\1_bn."),
    (r"^(ssh\d)\.(\w+)\.0\.", r"\1.\2_conv."),
    (r"^(ssh\d)\.(\w+)\.1\.", r"\1.\2_bn."),
    (r"^(ClassHead|BboxHead|LandmarkHead)\.(\d)\.conv1x1\.", r"\1_\2."),
    (r"^body\.stage1\.0\.0\.", r"body.stage1_0_conv."),
    (r"^body\.stage1\.0\.1\.", r"body.stage1_0_bn."),
    (r"^body\.stage(\d)\.(\d+)\.0\.", r"body.stage\1_\2_dw."),
    (r"^body\.stage(\d)\.(\d+)\.1\.", r"body.stage\1_\2_dw_bn."),
    (r"^body\.stage(\d)\.(\d+)\.3\.", r"body.stage\1_\2_pw."),
    (r"^body\.stage(\d)\.(\d+)\.4\.", r"body.stage\1_\2_pw_bn."),
    (r"^body\.(layer\d)\.(\d+)\.downsample\.(\d)\.",
     r"body.\1_\2.downsample_\3."),
    (r"^body\.(layer\d)\.(\d+)\.", r"body.\1_\2."),
]
# port leaf → (flax collection, leaf) for a BatchNorm and for a conv
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_CONV_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias")}


def retinaface_state_dict_from_jax(net: torch.nn.Module,
                                   variables: Dict) -> OrderedDict:
    """The `state_dict` of the port's `RetinaFace` holding the JAX
    package's flax `variables` (`params` and `batch_stats`). BatchNorm's
    scale/bias/mean/var become weight/bias/running_mean/running_var, convs
    go HWIO → OIHW. Strict both ways; `num_batches_tracked` has no flax leaf
    and is left out (a strict `load_state_dict` of a plain dict fills it)."""
    leaves = {(col,) + path: arr for col in ("params", "batch_stats")
              for path, arr in _leaves(variables.get(col, {})).items()}
    bn_modules = {name for name, m in net.named_modules()
                  if isinstance(m, torch.nn.BatchNorm2d)}
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        module, leaf = key.rsplit(".", 1)
        flax = module + "."
        for pat, rep in _RETINAFACE_RULES:
            flax, n = re.subn(pat, rep, flax)
            if n:
                break
        table = _BN_LEAVES if module in bn_modules else _CONV_LEAVES
        col, flax_leaf = table[leaf]
        path = (col,) + tuple(flax.rstrip(".").split(".")) + (flax_leaf,)
        if path not in leaves:
            raise KeyError(f"port key {key!r} has no flax counterpart "
                           f"({'/'.join(path)})")
        used.add(path)
        arr = leaves[path]
        if arr.ndim == 4:  # HWIO → OIHW (depthwise: (3,3,1,C) → (C,1,3,3))
            arr = arr.transpose(3, 2, 0, 1)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax {arr.shape} != port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax leaves unused: {unused[:10]}")
    return out


def state_dict_from_jax(net: torch.nn.Module, flax_params: Dict) -> OrderedDict:
    """The `state_dict` of port module `net` holding the JAX package's
    `flax_params` (a nested dict of arrays, the `params` collection)."""
    leaves = _leaves(flax_params)
    fixes = _flatten_fixes(net)
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        path = _resolve(flax_params, _flax_key(net, key).split("."))
        if path is None or path not in leaves:
            raise KeyError(f"port key {key!r} has no flax counterpart")
        if path in used:
            raise KeyError(f"flax leaf {'/'.join(path)} matched twice")
        used.add(path)
        flat = next((chw for p, chw in fixes.items() if key.startswith(p)),
                    None)
        arr = _fit(key, leaves[path], tuple(ref.shape), flat)
        out[key] = torch.from_numpy(arr.astype(np.float32))
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax params unused: {unused[:10]}")
    return out


def vgg_state_dict_from_jax(net: torch.nn.Module,
                            flax_params: Dict) -> OrderedDict:
    """The `state_dict` of the port's `VGGFeatureExtractor` holding the JAX
    package's flax params (`conv{block}_{i}/{kernel,bias}`): torchvision's
    `features.N` keys, convs HWIO → OIHW. Strict both ways."""
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        idx, leaf = key.split(".")[1:]
        name = net.names[int(idx)]
        flax_leaf = "kernel" if leaf == "weight" else leaf
        if name not in flax_params or flax_leaf not in flax_params[name]:
            raise KeyError(f"port key {key!r} ({name}) has no flax "
                           "counterpart")
        used.add((name, flax_leaf))
        arr = np.asarray(flax_params[name][flax_leaf], np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax {arr.shape} != port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    unused = sorted(f"{p}/{leaf}" for p, leaves in flax_params.items()
                    for leaf in leaves if (p, leaf) not in used)
    if unused:
        raise KeyError(f"{len(unused)} flax params unused: {unused[:10]}")
    return out


def discriminator_state_dict_from_jax(net: torch.nn.Module,
                                      variables: Dict) -> OrderedDict:
    """The `state_dict` of the port's `VGGStyleDiscriminator128/256` or
    `UNetDiscriminatorSN` holding the JAX package's flax `variables`
    (`params`, and `batch_stats` for the VGG-style ones): BatchNorm's
    scale/bias/mean/var become weight/bias/running_mean/running_var, conv
    kernels (a spectral-norm conv's is `weight_orig`) go HWIO → OIHW, dense
    kernels (in, out) → (out, in), with linear1's input features reordered
    from flax's (H, W, C) flatten to the reference's (C, H, W). Strict both
    ways; `num_batches_tracked` is left out (a strict load fills it)."""
    leaves = {(col,) + path: arr for col in ("params", "batch_stats")
              for path, arr in _leaves(variables.get(col, {})).items()}
    bn_modules = {name for name, m in net.named_modules()
                  if isinstance(m, torch.nn.BatchNorm2d)}
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        module, leaf = key.rsplit(".", 1)
        if module in bn_modules:
            col, flax_leaf = _BN_LEAVES[leaf]
        else:
            col = "params"
            flax_leaf = "bias" if leaf == "bias" else "kernel"
        path = (col, module, flax_leaf)
        if path not in leaves:
            raise KeyError(f"port key {key!r} has no flax counterpart "
                           f"({'/'.join(path)})")
        used.add(path)
        arr = leaves[path]
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
            if module == "linear1":  # a 4×4 map flattened
                c = ref.shape[1] // 16
                arr = arr.reshape(-1, 4, 4, c).transpose(0, 3, 1, 2) \
                    .reshape(arr.shape[0], -1)
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax {arr.shape} != port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(arr)
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax leaves unused: {unused[:10]}")
    return out


def qat_checkpoint_from_jax(net: torch.nn.Module, state: Dict) -> Dict:
    """A JAX SRModel's QAT training state (`params_g`, `ema_g`, `qscale`)
    as the port's checkpoint holds it: the SRVGG state_dicts of both
    parameter sets and the scales, which `serve.sr_engine.build_graph(
    qat_ckpt=...)` reads once `torch.save`d."""
    return {"params_g": state_dict_from_jax(net, state["params_g"]),
            "ema_g": state_dict_from_jax(net, state["ema_g"]),
            "qscale": torch.from_numpy(np.array(state["qscale"], np.float32))}


def stacked_state_dict_from_jax(net: torch.nn.Module,
                                stacked_params: Dict) -> OrderedDict:
    """The `state_dict` of a grouped port module (`net.groups` of them,
    e.g. `FacialComponentDiscriminator(groups=10)`) holding flax params
    stacked on a leading axis of `net.groups`: each group's slice is laid
    out by the general rules (a flax `nn.Conv` kernel is the port's
    `weight`), and the slices are concatenated on the port's axis 0."""
    g = net.groups
    leaves = _leaves(stacked_params)
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        path = _resolve(stacked_params, key.split("."))
        if path is None or path not in leaves:
            raise KeyError(f"port key {key!r} has no flax counterpart")
        used.add(path)
        arr = leaves[path]
        if arr.shape[0] != g:
            raise ValueError(f"{key}: leading axis {arr.shape[0]} != {g}")
        part = (ref.shape[0] // g,) + tuple(ref.shape[1:])
        arr = np.concatenate([_fit(key, a, part, None) for a in arr])
        out[key] = torch.from_numpy(arr.astype(np.float32))
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax params unused: {unused[:10]}")
    return out


def iresnet_state_dict_from_jax(net: torch.nn.Module, flax_params: Dict,
                                feat_hw: int = 7) -> OrderedDict:
    """The `state_dict` of the port's IResNet holding the JAX package's
    IResNet params: a FoldedBN (x·scale + shift) becomes a frozen BatchNorm
    with zero mean, unit variance, weight scale·√(1 + ε) and bias shift;
    `layerL_B` is `layerL.B`, `downsample_conv`/`downsample_bn` are
    `downsample.0`/`.1`; convs go HWIO → OIHW; `fc`'s input features go
    from flax's (H, W, C) flatten to the port's (C, H, W). Strict both
    ways; `num_batches_tracked` is left out (a strict load fills it)."""
    leaves = _leaves(flax_params)
    bn_modules = {name for name, m in net.named_modules()
                  if isinstance(m, torch.nn.BatchNorm2d)}
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        module, leaf = key.rsplit(".", 1)
        flax = re.sub(r"^layer(\d+)\.(\d+)", r"layer\1_\2", module)
        flax = flax.replace(".downsample.0", ".downsample_conv").replace(
            ".downsample.1", ".downsample_bn")
        parts = tuple(flax.split("."))
        if module in bn_modules:
            eps = net.get_submodule(module).eps
            scale = leaves.get(parts + ("scale",))
            shift = leaves.get(parts + ("shift",))
            if scale is None or shift is None:
                raise KeyError(f"port key {key!r} has no flax FoldedBN")
            used.update({parts + ("scale",), parts + ("shift",)})
            arr = {"weight": scale.astype(np.float64) * np.sqrt(1.0 + eps),
                   "bias": shift,
                   "running_mean": np.zeros(scale.shape),
                   "running_var": np.ones(scale.shape)}[leaf]
        else:
            path = parts if leaf == "weight" and parts in leaves else \
                parts + ("kernel" if leaf == "weight" else leaf,)
            if path not in leaves:
                raise KeyError(f"port key {key!r} has no flax counterpart "
                               f"({'/'.join(path)})")
            used.add(path)
            arr = leaves[path]
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # fc: (H·W·C, out) → (out, C·H·W)
                c = arr.shape[0] // (feat_hw * feat_hw)
                arr = arr.reshape(feat_hw, feat_hw, c, -1).transpose(
                    3, 2, 0, 1).reshape(arr.shape[1], -1)
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax {arr.shape} != port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(arr)
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax leaves unused: {unused[:10]}")
    return out


def hifacegan_state_dict_from_jax(net: torch.nn.Module,
                                  flax_params: Dict) -> OrderedDict:
    """The `state_dict` of a port HiFaceGAN, SPADEGenerator or
    HiFaceGANDiscriminator holding JAX's `flax_params`. Keys flax does not
    build (a HiFaceGAN's `fc`; the `to_rgbs` heads, and under
    `is_train`/`init_train_phase` the `ups` blocks, that the phase does not
    run) keep the net's own tensors; every other key must resolve and
    every flax leaf be used."""
    leaves = _leaves(flax_params)
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        tokens = re.sub(r"(logit\.1)\.weight$", r"\1.scale", key).split(".")
        path = _resolve(flax_params, tokens)
        if path is None or path not in leaves:
            if re.match(r"^(fc|to_rgbs\.\d|ups\.\d)\.", key):
                out[key] = ref.detach().clone()
                continue
            raise KeyError(f"port key {key!r} has no flax counterpart")
        if path in used:
            raise KeyError(f"flax leaf {'/'.join(path)} matched twice")
        used.add(path)
        out[key] = torch.from_numpy(
            _fit(key, leaves[path], tuple(ref.shape), None).astype(np.float32))
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax params unused: {unused[:10]}")
    return out


def inception_state_dict_from_jax(net: torch.nn.Module, params: Dict,
                                  batch_stats: Dict) -> OrderedDict:
    """The `state_dict` of the port's `InceptionV3` holding the JAX
    package's flax `params` and `batch_stats`: `X.conv.weight` is
    `X/conv/kernel` (HWIO → OIHW), `X.bn.{weight, bias}` are
    `X/bn/{scale, bias}` and `X.bn.running_{mean, var}` are the statistics'
    `X/bn/{mean, var}`; `num_batches_tracked` is left out (a strict load
    fills it). Strict both ways."""
    trees = {"params": _leaves(params), "batch_stats": _leaves(batch_stats)}
    leaf_map = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")}
    used = set()
    out = OrderedDict()
    for key, ref in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        module, leaf = key.rsplit(".", 1)
        parts = tuple(module.split("."))
        coll, name = ("params", "kernel") if parts[-1] == "conv" \
            else leaf_map[leaf]
        path = parts + (name,)
        if path not in trees[coll]:
            raise KeyError(f"port key {key!r} has no flax counterpart "
                           f"({coll}/{'/'.join(path)})")
        used.add((coll, path))
        arr = trees[coll][path]
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax {arr.shape} != port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(arr)
    unused = sorted(f"{c}/{'/'.join(p)}" for c, t in trees.items()
                    for p in t if (c, p) not in used)
    if unused:
        raise KeyError(f"{len(unused)} flax leaves unused: {unused[:10]}")
    return out
