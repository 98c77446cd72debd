#!/usr/bin/env python
"""Generate the markdown API reference from the package docstrings.

Stdlib-only (inspect + importlib) because this environment ships neither
sphinx nor mkdocs; the output is plain markdown under ``docs/api/`` — one
page per public module with class/method/function signatures and
docstrings — mirroring the coverage of the reference's sphinx API docs
(``/root/reference/docs/source/*.rst``, one page per module).

Usage: python scripts/build_api_docs.py [--out DIR] [--check]
  --check: exit non-zero if the output would change (CI freshness guard)
"""

import argparse
import importlib
import inspect
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# public modules, in the order the reference's docs index lists its
# equivalents (docs/source/index.rst), plus the device-pipeline additions
MODULES = [
    "getdist_tpu",
    "getdist_tpu.chains",
    "getdist_tpu.mcsamples",
    "getdist_tpu.densities",
    "getdist_tpu.gaussian_mixtures",
    "getdist_tpu.kde_bandwidth",
    "getdist_tpu.paramnames",
    "getdist_tpu.parampriors",
    "getdist_tpu.inifile",
    "getdist_tpu.covmat",
    "getdist_tpu.types",
    "getdist_tpu.plots",
    "getdist_tpu.matplotlib_ext",
    "getdist_tpu.chain_grid",
    "getdist_tpu.cobaya_interface",
    "getdist_tpu.arviz_wrapper",
    "getdist_tpu.yaml_tools",
    "getdist_tpu.command_line",
    "getdist_tpu.backend",
    "getdist_tpu.ops.convolve",
    "getdist_tpu.ops.fft",
    "getdist_tpu.ops.batched",
    "getdist_tpu.ops.stats",
    "getdist_tpu.ops.parity_device",
    "getdist_tpu.ops.histograms",
    "getdist_tpu.ops.binning",
    "getdist_tpu.parallel.mesh",
    "getdist_tpu.parallel.reductions",
    "getdist_tpu.models.fisher",
    "getdist_tpu.gui.app_logic",
    "getdist_tpu.gui.plot_script",
]


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return "\n".join(indent + line for line in doc.split("\n"))


def _is_public(name):
    return not name.startswith("_")


def _document_class(cls, lines):
    lines.append(f"### class `{cls.__name__}{_signature(cls)}`\n")
    doc = _doc(cls)
    if doc:
        lines.append(doc + "\n")
    members = inspect.getmembers(cls)
    for name, member in members:
        if not _is_public(name):
            continue
        if inspect.isfunction(member) or inspect.ismethod(member):
            # only methods defined by this class (not inherited library ones)
            qualname = getattr(member, "__qualname__", "")
            if not qualname.startswith(cls.__name__ + "."):
                continue
            lines.append(f"#### `{cls.__name__}.{name}{_signature(member)}`\n")
            doc = _doc(member)
            if doc:
                lines.append(doc + "\n")
        elif isinstance(member, property):
            lines.append(f"#### property `{cls.__name__}.{name}`\n")
            doc = _doc(member)
            if doc:
                lines.append(doc + "\n")


def document_module(modname):
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`\n"]
    doc = _doc(mod)
    if doc:
        lines.append(doc + "\n")
    exported = getattr(mod, "__all__", None)
    classes, functions = [], []
    for name, member in inspect.getmembers(mod):
        if not _is_public(name):
            continue
        if exported is not None and name not in exported and getattr(member, "__module__", None) != modname:
            continue
        if getattr(member, "__module__", None) != modname:
            continue
        if inspect.isclass(member):
            classes.append(member)
        elif inspect.isfunction(member) or (
            callable(member) and hasattr(member, "__wrapped__")  # jax.jit etc.
        ):
            functions.append((name, member))
    if functions:
        lines.append("## Functions\n")
        for name, fn in functions:
            lines.append(f"### `{name}{_signature(fn)}`\n")
            doc = _doc(fn)
            if doc:
                lines.append(doc + "\n")
    if classes:
        lines.append("## Classes\n")
        for cls in classes:
            _document_class(cls, lines)
    return "\n".join(lines) + "\n"


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=os.path.join(REPO, "docs", "api"))
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args()

    os.makedirs(args.out, exist_ok=True)
    index = [
        "# API reference\n",
        "Generated from the package docstrings by `scripts/build_api_docs.py`",
        "(stdlib introspection; this environment has no sphinx). Regenerate",
        "after changing any public docstring.\n",
    ]
    changed = []
    for modname in MODULES:
        try:
            text = document_module(modname)
        except Exception as e:  # optional deps (e.g. arviz) may be absent
            text = f"# `{modname}`\n\n(unavailable in this environment: {e})\n"
        fname = modname.replace(".", "_") + ".md"
        path = os.path.join(args.out, fname)
        old = open(path).read() if os.path.exists(path) else None
        if old != text:
            changed.append(fname)
            if not args.check:
                with open(path, "w") as f:
                    f.write(text)
        index.append(f"- [{modname}]({fname})")
    index_text = "\n".join(index) + "\n"
    index_path = os.path.join(args.out, "index.md")
    old = open(index_path).read() if os.path.exists(index_path) else None
    if old != index_text:
        changed.append("index.md")
        if not args.check:
            with open(index_path, "w") as f:
                f.write(index_text)
    if args.check and changed:
        print("API docs stale:", ", ".join(changed))
        return 1
    print(f"API reference: {len(MODULES)} module pages in {args.out}" + (" (stale)" if changed else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
