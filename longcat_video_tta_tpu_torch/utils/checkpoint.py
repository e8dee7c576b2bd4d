"""Run progress checkpointing and result persistence (counterpart of
``longcat_video_tta_tpu/utils/checkpoint.py``): ``checkpoint.json``
{next_idx, results} after every video, ``summary.json`` at the end,
``config.json`` per run, each written atomically."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional


def _json_default(o):
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "item"):
        return o.item()
    return str(o)


def _atomic_write_json(path: str, obj: Any):
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2, default=_json_default)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(path: str, next_idx: int, results: List[Dict]):
    _atomic_write_json(path, {"next_idx": next_idx, "results": results})


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_results(path: str, summary: Dict[str, Any]):
    _atomic_write_json(path, summary)


def environment_provenance() -> Dict[str, Any]:
    """Library versions and the device inventory, recorded into every
    run's config.json."""
    import sys

    import numpy as np
    import torch

    prov: Dict[str, Any] = {"python": sys.version.split()[0],
                            "torch": torch.__version__, "numpy": np.__version__,
                            "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        prov["device"] = torch.cuda.get_device_name(0)
        prov["num_devices"] = torch.cuda.device_count()
    return prov


def save_config(path: str, config: Dict[str, Any]):
    doc = dict(config)
    doc.setdefault("environment", environment_provenance())
    _atomic_write_json(path, doc)


def save_adapter_state(path: str, train_params: Dict[str, Any]) -> str:
    """One video's trained tensors as a ``torch.save`` of a dict of CPU
    tensors at ``path`` (the LongCat reference's own adapter format,
    run_lora_tta.py:412-418; the JAX package writes orbax instead).
    Written atomically; returns ``path``."""
    import torch

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in train_params.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_adapter_state(path: str, device="cpu") -> Dict[str, Any]:
    """The tensors ``save_adapter_state`` wrote, on ``device``."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device) for k, v in state.items()}
