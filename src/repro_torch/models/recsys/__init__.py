"""The recsys families.  ``_RECSYS_MODS`` maps a ``RecsysConfig.kind`` to
its model module (the reference keeps this table in
``launch/bindings.py``)."""
from repro_torch.models.recsys import bst, din, dlrm, two_tower

_RECSYS_MODS = {"din": din, "bst": bst, "dlrm": dlrm, "two_tower": two_tower}
