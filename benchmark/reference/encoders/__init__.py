"""The image encoders of the reference, one family a module.

A configuration file names its encoder's family in `published.encoder`;
the family is this package's module of that name, found by import, so a
new family is a new file here and nothing else. A file without the key
is SAM's ViT, the default. Each family module gives:

  param_specs(arch)           the encoder's leaves (name, shape, init), in
                              the program's state-dict order
  forward(sd, rgb, arch, prec)  rgb [B, P, P, 3] in 0-255 -> embeddings
                              [B, 256, P / 16, P / 16]
  grid(arch)                  the side of the embedding
  flops(arch), params(arch)   one patch's forward operations, and the
                              encoder's parameter count

and any counts that its own metrics need. `arch` is a configuration
file's `published` block plus its PATCH_SIZE.
"""

from __future__ import annotations

import importlib

DEFAULT = "sam_vit"


def family(arch: dict):
    """The module of the family that `arch` names."""
    return importlib.import_module(f"{__name__}.{arch.get('encoder', DEFAULT)}")
