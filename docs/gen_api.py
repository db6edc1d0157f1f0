"""Generated API reference: dependency-free autodocs over docstrings.

The reference ships a Documenter.jl autodocs site built from docstrings
(/root/reference/docs/make.jl:10-25). This is its equivalent here: no
sphinx/mkdocs in the image, so a small inspector walks the public package
surface and emits one markdown page per module under docs/api/ plus an
index — every signature and docstring in the library, generated, not
hand-written. CI runs it and publishes docs/ as the site artifact.

Usage: python docs/gen_api.py [outdir]   (default docs/api)
"""
from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MODULES = [
    "enflows_tpu",
    "enflows_tpu.bijectors.base",
    "enflows_tpu.bijectors.scale_shift",
    "enflows_tpu.bijectors.center_stretch",
    "enflows_tpu.bijectors.johnson",
    "enflows_tpu.bijectors.householder",
    "enflows_tpu.bijectors.coupling",
    "enflows_tpu.bijectors.spline",
    "enflows_tpu.distributions.base",
    "enflows_tpu.distributions.johnson_su",
    "enflows_tpu.train.whitening",
    "enflows_tpu.train.vi",
    "enflows_tpu.mcmc.logdensity",
    "enflows_tpu.mcmc.hmc",
    "enflows_tpu.mcmc.nuts",
    "enflows_tpu.mcmc.chees",
    "enflows_tpu.mcmc.adaptation",
    "enflows_tpu.mcmc.sample",
    "enflows_tpu.mcmc.diagnostics",
    "enflows_tpu.smc.smc",
    "enflows_tpu.smc.flow_transport",
    "enflows_tpu.parallel.mesh",
    "enflows_tpu.parallel.collectives",
    "enflows_tpu.parallel.resample",
    "enflows_tpu.parallel.mcmc_sharded",
    "enflows_tpu.parallel.smc_sharded",
    "enflows_tpu.parallel.event_sharded",
    "enflows_tpu.infer",
    "enflows_tpu.utils.pytree",
    "enflows_tpu.utils.checkpoint",
    "enflows_tpu.utils.metrics",
    "enflows_tpu.utils.profiling",
    "enflows_tpu.utils.debugging",
    "enflows_tpu.utils.resilience",
    "enflows_tpu.utils.config",
    "enflows_tpu.cli",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(no docstring)*"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # Only document things defined in (or re-exported by) the package.
        owner = getattr(obj, "__module__", "")
        if not (owner or "").startswith("enflows_tpu"):
            continue
        out.append((n, obj))
    return out


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", "", _doc(mod), ""]
    members = _public_members(mod)
    classes = [(n, o) for n, o in members if inspect.isclass(o)]
    funcs = [(n, o) for n, o in members
             if inspect.isfunction(o) or inspect.isbuiltin(o)]
    for n, cls in classes:
        lines += [f"## class `{n}{_sig(cls)}`", "", _doc(cls), ""]
        for mn, m in inspect.getmembers(cls):
            if mn.startswith("_") or not (inspect.isfunction(m)
                                          or inspect.ismethod(m)):
                continue
            if m.__qualname__.split(".")[0] != cls.__name__:
                continue      # inherited
            lines += [f"### `{n}.{mn}{_sig(m)}`", "", _doc(m), ""]
    for n, f in funcs:
        lines += [f"## `{n}{_sig(f)}`", "", _doc(f), ""]
    return "\n".join(lines)


def main(outdir: str = None) -> list[str]:
    outdir = outdir or os.path.join(os.path.dirname(__file__), "api")
    os.makedirs(outdir, exist_ok=True)
    written = []
    index = ["# API reference", "",
             "Generated from docstrings by `docs/gen_api.py` "
             "(the Documenter.jl-autodocs equivalent).", ""]
    for modname in MODULES:
        page = modname.replace(".", "_") + ".md"
        path = os.path.join(outdir, page)
        with open(path, "w") as f:
            f.write(render_module(modname))
        written.append(path)
        mod = importlib.import_module(modname)
        first = (inspect.getdoc(mod) or "").split("\n")[0]
        index.append(f"- [`{modname}`]({page}) — {first}")
    with open(os.path.join(outdir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    written.append(os.path.join(outdir, "index.md"))
    return written


if __name__ == "__main__":
    out = main(sys.argv[1] if len(sys.argv) > 1 else None)
    print(f"wrote {len(out)} pages to {os.path.dirname(out[0])}")
