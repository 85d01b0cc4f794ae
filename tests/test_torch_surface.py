"""The port's surface against the JAX package's, read from the sources (AST
only: neither package is imported).

* Every public top-level function and class of each module of
  `image_restoration_tpu/` (but `ops/pallas/`) is bound at the top level of
  the port module of the same relative path, or is named in SURFACE.
* Every `add_argument` name of a JAX command line (and every `"--flag" in
  sys.argv` test of one) is one of its port counterpart's (CLIS gives the
  counterparts that do not follow the default path), or is named in FLAGS;
  a JAX command line with no counterpart is named in CLIS with its reason.
* Every `pl.pallas_call` of the JAX package lies in a function named in
  KERNELS, whose `csrc/` source and `irt::` op exist in the port.
* No entry names something the JAX package does not have (stale), none
  names what the port already has under the same name, and every reason
  quotes the ROADMAP.md bullet that states it.

The registry types are held apart, by
`tests/test_torch_sr_train.py::test_port_registry_names_are_jax_names`.
"""

import ast
import functools
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "image_restoration_tpu", "image_restoration_tpu_torch"

RENAMED = "renamed"          # → "port/module.py:Name" (or a flag), which must exist
NOT_NEEDED = "not_needed"    # → a quote of the ROADMAP bullet that says why
DEPARTURE = "departure"      # → a quote of the ROADMAP bullet that states it
BENCHMARK = "benchmark"      # → a quote: the first benchmark PR replaces it
REASONED = (NOT_NEEDED, DEPARTURE, BENCHMARK)

# JAX public names (or whole modules) with no port counterpart of the same
# name, keyed "module.py:Name" (or "module.py") relative to the package
SURFACE = {
    "archs/arch_util.py:PixelShuffleUpsample": (
        RENAMED, "archs/arch_util.py:Upsample"),
    "archs/arch_util.py:conv_kaiming": (RENAMED, "archs/arch_util.py:Conv"),
    "archs/arch_util.py:kaiming_scaled": (
        RENAMED, "archs/arch_util.py:init_conv_"),
    "archs/dfdnet_arch.py:AttentionBlock": (
        RENAMED, "archs/dfdnet_arch.py:attention_block"),
    "archs/gfpgan_ocr_arch.py:SFTCondition": (
        RENAMED, "archs/gfpgan_ocr_arch.py:sft_condition"),
    "archs/iresnet_arch.py:FoldedBN": (
        RENAMED, "archs/iresnet_arch.py:FrozenBatchNorm"),
    "archs/ridnet_arch.py:RIDChannelAttention": (
        RENAMED, "archs/arch_util.py:ChannelAttention"),
    "archs/vgg_arch.py:vgg19_layer_names": (
        RENAMED, "archs/vgg_arch.py:vgg_layer_names"),
    "convert/dfdnet_import.py:convert_dfdnet_dict": (
        RENAMED, "convert/dfdnet_import.py:load_dfdnet_dict"),
    "convert/dfdnet_import.py:load_torch_dfdnet": (
        RENAMED, "convert/dfdnet_import.py:load_dfdnet"),
    "convert/hifacegan_import.py:load_torch_hifacegan_block": (
        RENAMED, "convert/hifacegan_import.py:load_hifacegan"),
    "detect/box_utils.py:nms_jax": (RENAMED, "detect/box_utils.py:nms"),
    "detect/synth.py:synth_scene": (RENAMED, "detect/synth.py:render_scenes"),
    "convert/torch_import.py": (
        NOT_NEEDED, "the JAX-side converters (`convert/torch_import.py`"),
    "convert/retinaface_import.py": (NOT_NEEDED, "`retinaface_import.py`"),
    "convert/vgg_import.py": (NOT_NEEDED, "`vgg_import.py`"),
    "utils/download_util.py": (
        NOT_NEEDED, "`utils/download_util.py`, "
                    "`scripts/download_pretrained_models.py`"),
    "archs/arch_util.py:make_layer": (
        DEPARTURE, "`make_layer` has no counterpart"),
    "models/__init__.py:register_all_models": (
        DEPARTURE, "`register_all_models` has no counterpart"),
    "serve/api.py:create_app": (
        DEPARTURE, "`create_app` (FastAPI) has no counterpart"),
    "utils/debug.py:checkify_step": (
        DEPARTURE, "`debug_nans` is autograd's anomaly mode"),
    "utils/logger.py:init_wandb_logger": (
        DEPARTURE, "wandb is not ported"),
}

# JAX command lines (paths from the repo root) whose counterpart is not the
# default one (the same path in the port's package; for `scripts/**/x.py`,
# the port's `scripts/x.py`), or that have none
_BENCH = (BENCHMARK, "the root `scripts/bench_*.py` and "
                     "`scripts/profile_*.py` tools")
_CONVERSION = (NOT_NEEDED, "`scripts/model_conversion/`")
CLIS = {
    "api.py": f"{PORT_PKG}/serve/api.py",
    "bench.py": (BENCHMARK, "`bench.py` with its halo-4 seam gate"),
    "scripts/bench_detector_convergence.py":
        f"{PORT_PKG}/scripts/detector_convergence.py",
    "scripts/bench_dcn.py": _BENCH,
    "scripts/bench_distill_e2e.py": f"{PORT_PKG}/scripts/distill_e2e.py",
    "scripts/bench_e2e.py": _BENCH,
    "scripts/bench_experiments.py": _BENCH,
    "scripts/bench_gan_ablation.py": f"{PORT_PKG}/scripts/gan_ablation.py",
    "scripts/bench_gfpgan_longrun.py":
        f"{PORT_PKG}/scripts/gfpgan_longrun.py",
    "scripts/bench_microbatch.py": _BENCH,
    "scripts/bench_qat_distill.py": f"{PORT_PKG}/scripts/qat_distill.py",
    "scripts/bench_rrdb.py": _BENCH,
    # `--convergence`; the step-timing modes' flags are in FLAGS
    "scripts/bench_train.py": f"{PORT_PKG}/scripts/train_convergence.py",
    "scripts/bench_video.py": _BENCH,
    "scripts/profile_degrade.py": _BENCH,
    "scripts/profile_train.py": _BENCH,
    "scripts/model_conversion/convert_dfdnet.py": _CONVERSION,
    "scripts/model_conversion/convert_models.py": _CONVERSION,
    "scripts/model_conversion/convert_stylegan.py": _CONVERSION,
    "scripts/download_pretrained_models.py": (
        NOT_NEEDED, "`scripts/download_pretrained_models.py`"),
    "scripts/data_preparation/download_datasets.py": (
        NOT_NEEDED, "`scripts/data_preparation/download_datasets.py`, "
                    "since nothing can be downloaded here"),
    "scripts/publish_models.py": (
        NOT_NEEDED, "`scripts/publish_models.py` hashes files of any "
                    "format"),
    # these import neither JAX nor the JAX package, so name them here
    "scripts/data_preparation/generate_meta_info.py":
        f"{PORT_PKG}/scripts/generate_meta_info.py",
    "scripts/data_preparation/regroup_reds_dataset.py":
        f"{PORT_PKG}/scripts/regroup_reds_dataset.py",
}

# JAX flags, "cli.py:flag", that the port's counterpart names otherwise
_STEP_TIMING = (BENCHMARK, "`scripts/bench_train.py`'s step-timing modes")
FLAGS = {
    "scripts/matlab_scripts.py:--cpu": (RENAMED, "--device"),
    **{f"scripts/bench_train.py:{flag}": _STEP_TIMING
       for flag in ("--mode", "--batch-sizes", "--dtype", "--iters",
                    "--breakdown", "--breakdown-bs", "--remat",
                    "--detector")},
}

# the function around each `pl.pallas_call` → the port's source and op
KERNELS = {
    "ops/pallas/fused_act_kernel.py:fused_bias_lrelu_pallas": (
        "csrc/fused_bias_act.cu", "irt::fused_bias_lrelu"),
    "ops/pallas/int8_conv.py:int8_conv3x3_requant": (
        "csrc/int8_conv3x3.cu", "irt::int8_conv3x3_requant"),
    "ops/pallas/im2col_conv.py:conv3x3_im2col": (
        "csrc/conv3x3_im2col.cu", "irt::conv3x3_im2col"),
}


# ------------------------------------------------------------ the checker


@functools.lru_cache(maxsize=None)
def _parse(path: Path) -> ast.Module:
    return ast.parse(_text(path), str(path))


def _top_statements(body):
    """The module's statements, those inside top-level if/try/with too."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody"):
                yield from _top_statements(getattr(node, field, []))
            for handler in getattr(node, "handlers", []):
                yield from _top_statements(handler.body)


def public_defs(path: Path) -> set:
    return {n.name for n in _parse(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def bound_names(path: Path) -> set:
    """Every name the module binds at its top level."""
    out = set()
    for n in _top_statements(_parse(path).body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out |= {x.id for x in ast.walk(t) if isinstance(x, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


@functools.lru_cache(maxsize=None)
def _text(path: Path) -> str:
    return path.read_text(encoding="utf-8")


def _calls(path: Path, attr: str):
    if attr not in _text(path):   # skip the parse
        return
    for n in ast.walk(_parse(path)):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == attr:
            yield n


def cli_flags(path: Path) -> set:
    """The `add_argument` names, and the flags tested as `"--x" in
    sys.argv` (or `not in`)."""
    flags = {a.value for c in _calls(path, "add_argument") for a in c.args
             if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    if "sys.argv" in _text(path):
        for n in ast.walk(_parse(path)):
            if isinstance(n, ast.Compare) and isinstance(n.left, ast.Constant) \
                    and isinstance(n.left.value, str) \
                    and n.left.value.startswith("--") \
                    and isinstance(n.ops[0], (ast.In, ast.NotIn)) \
                    and ast.unparse(n.comparators[0]) == "sys.argv":
                flags.add(n.left.value)
    return flags


def custom_ops(path: Path) -> set:
    return {c.args[0].value for c in _calls(path, "custom_op")
            if c.args and isinstance(c.args[0], ast.Constant)}


def pallas_sites(path: Path) -> set:
    """The top-level functions that call `pl.pallas_call`."""
    if "pallas_call" not in _text(path):
        return set()
    return {n.name for n in _parse(path).body
            if isinstance(n, ast.FunctionDef) and any(
                isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and c.func.attr == "pallas_call" for c in ast.walk(n))}


def imports_jax(path: Path, jax_pkg: str) -> bool:
    if "jax" not in _text(path) and jax_pkg not in _text(path):
        return False
    for n in ast.walk(_parse(path)):
        mods = ([a.name for a in n.names] if isinstance(n, ast.Import) else
                [n.module or ""] if isinstance(n, ast.ImportFrom) else [])
        if any(m.split(".")[0] in ("jax", jax_pkg) for m in mods):
            return True
    return False


def _norm(text: str) -> str:
    return re.sub(r"\s+", " ", text)


def surface_faults(repo: Path, jax_pkg: str, port_pkg: str, roadmap: str,
                   surface: dict, clis: dict, flags: dict,
                   kernels: dict) -> dict:
    """The faults of the port's surface, by kind: "missing" (a JAX name
    or module the port lacks), "flag", "kernel", "stale" (an entry for
    something JAX lacks, or the port has by the same name; a renamed
    target the port lacks) and "reason" (a quote ROADMAP.md lacks)."""
    faults = {k: [] for k in ("missing", "flag", "kernel", "stale",
                              "reason")}
    jax_root, port_root = repo / jax_pkg, repo / port_pkg
    roadmap = _norm(roadmap)
    jax_files = sorted(jax_root.rglob("*.py"))

    def reasoned(key, entry):
        if entry[0] not in REASONED:
            faults["stale"].append(f"{key}: unknown kind {entry[0]!r}")
        elif _norm(entry[1]) not in roadmap:
            faults["reason"].append(f"{key}: ROADMAP.md does not say "
                                    f"{entry[1]!r}")

    # public names, module by module
    for path in jax_files:
        rel = path.relative_to(jax_root).as_posix()
        if rel.startswith("ops/pallas/") or rel in surface:
            continue
        port = port_root / rel
        have = bound_names(port) if port.exists() else set()
        for name in sorted(public_defs(path)):
            key = f"{rel}:{name}"
            if name in have and key in surface:
                faults["stale"].append(f"{key}: the port has {name}")
            elif name not in have and key not in surface:
                faults["missing"].append(f"{port_pkg}/{rel}: no {name}")
    for key, entry in surface.items():
        rel, _, name = key.partition(":")
        path = jax_root / rel
        if not path.exists() or (name and name not in public_defs(path)):
            faults["stale"].append(f"{key}: not in {jax_pkg}")
        if entry[0] == RENAMED:
            prel, _, pname = entry[1].partition(":")
            if not (port_root / prel).exists() or \
                    pname not in bound_names(port_root / prel):
                faults["stale"].append(f"{key}: no {port_pkg}/{entry[1]}")
        else:
            reasoned(key, entry)

    # command lines
    found = {p.relative_to(repo).as_posix(): p for p in jax_files}
    for p in sorted((repo / "scripts").rglob("*.py")) + \
            sorted(repo.glob("*.py")):
        rel = p.relative_to(repo).as_posix()
        if rel in clis or imports_jax(p, jax_pkg):
            found[rel] = p
    for rel, path in found.items():
        jflags = cli_flags(path)
        if not jflags:
            continue
        target = clis.get(rel)
        if target is None:
            target = (f"{port_pkg}/{rel[len(jax_pkg) + 1:]}"
                      if rel.startswith(jax_pkg + "/") else
                      f"{port_pkg}/scripts/{path.name}")
        if not isinstance(target, str):
            continue
        if not (repo / target).exists():
            faults["missing"].append(f"{rel}: no counterpart {target}")
            continue
        pflags = cli_flags(repo / target)
        for flag in sorted(jflags):
            entry = flags.get(f"{rel}:{flag}")
            if flag in pflags and entry is not None:
                faults["stale"].append(f"{rel}:{flag}: {target} has it")
            elif flag not in pflags and entry is None:
                faults["flag"].append(f"{target}: no {flag} (of {rel})")
            elif entry is not None and entry[0] == RENAMED \
                    and entry[1] not in pflags:
                faults["stale"].append(f"{rel}:{flag}: {target} has no "
                                       f"{entry[1]}")
            elif entry is not None and entry[0] != RENAMED:
                reasoned(f"{rel}:{flag}", entry)
    for rel, target in clis.items():
        if not (repo / rel).exists() or not cli_flags(repo / rel):
            faults["stale"].append(f"{rel}: no such command line")
        elif not isinstance(target, str):
            reasoned(rel, target)
    for key in flags:
        rel, _, flag = key.partition(":")
        if not (repo / rel).exists() or flag not in cli_flags(repo / rel):
            faults["stale"].append(f"{key}: no such flag")

    # kernels
    ops = set()
    for p in port_root.rglob("*.py"):
        ops |= custom_ops(p)
    sites = {f"{p.relative_to(jax_root).as_posix()}:{f}"
             for p in jax_files for f in pallas_sites(p)}
    for site in sorted(sites - set(kernels)):
        faults["kernel"].append(f"{site}: pallas_call with no Hopper op")
    for site, (source, op) in kernels.items():
        if site not in sites:
            faults["stale"].append(f"{site}: no pallas_call there")
        if not (port_root / source).exists():
            faults["kernel"].append(f"{site}: no {port_pkg}/{source}")
        if op not in ops:
            faults["kernel"].append(f"{site}: no custom op {op}")
    return faults


@pytest.fixture(scope="module")
def faults():
    return surface_faults(REPO, JAX_PKG, PORT_PKG,
                          (REPO / "ROADMAP.md").read_text(encoding="utf-8"),
                          SURFACE, CLIS, FLAGS, KERNELS)


def test_port_has_every_public_jax_name(faults):
    assert faults["missing"] == []


def test_port_command_lines_take_every_jax_flag(faults):
    assert faults["flag"] == []


def test_every_pallas_kernel_has_its_hopper_op(faults):
    assert faults["kernel"] == []


def test_surface_tables_hold_no_stale_entry(faults):
    assert faults["stale"] == []


def test_surface_reasons_quote_the_roadmap(faults):
    assert faults["reason"] == []


def test_checker_catches_a_missing_name_a_missing_flag_and_a_stale_entry(
        tmp_path):
    def write(rel, text):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)

    write("jx/mod.py", "def kept():\n    pass\n\n\ndef dropped():\n    pass\n"
          "\n\nclass Moved:\n    pass\n\n\ndef _private():\n    pass\n")
    write("jx/cli.py", "import argparse, sys\np = argparse.ArgumentParser()\n"
          "p.add_argument('--a')\np.add_argument('--b')\n"
          "tiny = '--c' in sys.argv\n")
    write("jx/ops/pallas/k.py", "def kern(x):\n    return pl.pallas_call(f)(x)\n")
    write("pt/mod.py", "from .other import kept\n")
    write("pt/other.py", "def kept():\n    pass\n\n\nclass Renamed:\n    pass\n")
    write("pt/cli.py", "import argparse\np = argparse.ArgumentParser()\n"
          "p.add_argument('--a')\np.add_argument('--c')\n")
    write("pt/csrc/k.cu", "")
    write("pt/ops/k.py", "@torch.library.custom_op('irt::k', mutates_args=())"
          "\ndef k(x):\n    return x\n")
    kernels = {"ops/pallas/k.py:kern": ("csrc/k.cu", "irt::k")}
    surface = {"mod.py:Moved": (RENAMED, "other.py:Renamed")}

    def run(surface=surface, roadmap=""):
        return surface_faults(tmp_path, "jx", "pt", roadmap, surface, {}, {},
                              kernels)

    got = run()
    assert got["missing"] == ["pt/mod.py: no dropped"]
    assert got["flag"] == ["pt/cli.py: no --b (of jx/cli.py)"]
    assert got["stale"] == got["kernel"] == got["reason"] == []

    got = run({**surface, "mod.py:gone": (DEPARTURE, "kept elsewhere"),
               "mod.py:dropped": (NOT_NEEDED, "not here")})
    assert got["missing"] == []
    assert got["stale"] == ["mod.py:gone: not in jx"]
    assert got["reason"] == [
        "mod.py:gone: ROADMAP.md does not say 'kept elsewhere'",
        "mod.py:dropped: ROADMAP.md does not say 'not here'"]
    assert run({**surface, "mod.py:dropped": (NOT_NEEDED, "not here")},
               roadmap="- not\n  here.")["reason"] == []
