"""Workspace configuration (counterpart of
``bicubic_interpolation_model_tpu/utils/config.py``): a dataclass with JSON
persistence (``bim_tpu.json`` at the workspace root, the file the JAX
package writes), for defaults such as the image id (the reference's HRID
knob); everything stays overridable per call.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib


@dataclasses.dataclass
class WorkspaceConfig:
    hrid: str = "0020"          # the reference's single global knob
    scale: int = 4
    a: float = -0.5             # Keys cubic parameter (MN in the reference)
    lanczos_a: int = 3
    down_method: str = "lanczos3"   # LR generation kernel (msr flow)
    data_down_method: str = "cubic"  # training-data downsample kernel

    @classmethod
    def load(cls, workspace=".") -> "WorkspaceConfig":
        p = pathlib.Path(workspace) / "bim_tpu.json"
        if p.exists():
            known = {f.name for f in dataclasses.fields(cls)}
            raw = {k: v for k, v in json.loads(p.read_text()).items()
                   if k in known}
            return cls(**raw)
        return cls()

    def save(self, workspace=".") -> pathlib.Path:
        p = pathlib.Path(workspace) / "bim_tpu.json"
        p.write_text(json.dumps(dataclasses.asdict(self), indent=2))
        return p
