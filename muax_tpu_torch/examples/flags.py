"""Command-line flags of the example scripts in absl's spellings, over
``argparse`` (the card's machine has no absl): ``--name value`` or
``--name=value``, and a boolean as ``--name`` / ``--noname``, so that the
JAX scripts' command lines run unchanged."""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
  """A parser described by the first line of ``doc``, with ``--device``
  (``cuda`` by default; ``cpu`` runs the kernels' plain versions)."""
  p = argparse.ArgumentParser(description=doc.splitlines()[0])
  p.add_argument("--device", default="cuda",
                 help="cuda, or cpu for the kernels' plain versions")
  return p


def add_bool(p: argparse.ArgumentParser, name: str, default: bool,
             help: str) -> None:
  """``--name`` sets it, ``--noname`` clears it (absl's boolean flags)."""
  p.add_argument(f"--{name}", dest=name, action="store_true", help=help)
  p.add_argument(f"--no{name}", dest=name, action="store_false")
  p.set_defaults(**{name: default})
