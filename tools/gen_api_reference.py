"""Generate docs/api_reference.md from the package's docstrings.

Counterpart of the reference's Doxygen pipeline (Doxyfile + docs/, 618
generated pages): a dependency-free docstring walker that emits one
markdown reference covering every public module, class, method and
function in rapidnet_jax, with signatures.

Usage: python tools/gen_api_reference.py [--out docs/api_reference.md]
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import pkgutil
import sys


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj, indent: str = "") -> str:
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return "\n".join(indent + line for line in doc.splitlines())


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def document_module(mod, lines: list[str]) -> None:
    lines.append(f"\n## `{mod.__name__}`\n")
    if inspect.getdoc(mod):
        lines.append(_doc(mod) + "\n")

    members = [(n, o) for n, o in inspect.getmembers(mod)
               if _is_public(n) and getattr(o, "__module__", None)
               == mod.__name__]
    classes = [(n, o) for n, o in members if inspect.isclass(o)]
    funcs = [(n, o) for n, o in members if inspect.isfunction(o)]
    consts = [(n, o) for n, o in inspect.getmembers(mod)
              if _is_public(n) and isinstance(o, (int, float, str))
              and not inspect.ismodule(o)
              and n.isupper()]

    if consts:
        lines.append("**Constants**\n")
        for n, o in consts:
            lines.append(f"- `{n} = {o!r}`")
        lines.append("")

    for name, cls in classes:
        lines.append(f"### class `{name}{_sig(cls)}`\n")
        if inspect.getdoc(cls):
            lines.append(_doc(cls) + "\n")
        for mname, meth in inspect.getmembers(cls):
            if not _is_public(mname):
                continue
            if not (inspect.isfunction(meth) or isinstance(
                    meth, (classmethod, staticmethod, property))):
                continue
            if isinstance(meth, property):
                lines.append(f"#### property `{name}.{mname}`\n")
                if inspect.getdoc(meth):
                    lines.append(_doc(meth) + "\n")
                continue
            fn = meth.__func__ if isinstance(
                meth, (classmethod, staticmethod)) else meth
            if getattr(fn, "__qualname__", "").split(".")[0] != name:
                continue  # inherited
            lines.append(f"#### `{name}.{mname}{_sig(fn)}`\n")
            if inspect.getdoc(fn):
                lines.append(_doc(fn) + "\n")

    for name, fn in funcs:
        lines.append(f"### `{name}{_sig(fn)}`\n")
        if inspect.getdoc(fn):
            lines.append(_doc(fn) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "api_reference.md"))
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import rapidnet_jax

    lines = [
        "# rapidnet_jax API reference",
        "",
        "Generated from docstrings by `tools/gen_api_reference.py` — "
        "do not edit by hand.  Counterpart of the reference's Doxygen "
        "API docs (`/root/reference/Doxyfile`, `docs/`).",
    ]
    mods = []
    pkgpath = rapidnet_jax.__path__
    for info in sorted(pkgutil.walk_packages(pkgpath, "rapidnet_jax."),
                       key=lambda i: i.name):
        if ".native" in info.name and info.name.endswith("src"):
            continue
        try:
            mods.append(importlib.import_module(info.name))
        except Exception as exc:  # noqa: BLE001
            print(f"skip {info.name}: {exc}", file=sys.stderr)
    document_module(rapidnet_jax, lines)
    for mod in mods:
        document_module(mod, lines)

    out = "\n".join(lines) + "\n"
    with open(args.out, "w") as f:
        f.write(out)
    n_sections = out.count("\n### ") + out.count("\n#### ")
    print(f"wrote {args.out}: {len(out.splitlines())} lines, "
          f"{len(mods) + 1} modules, {n_sections} documented symbols")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
