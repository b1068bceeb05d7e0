"""File and stdout logger and the run directory layout.

Port of ``Logger`` and ``set_log`` (ccsd_tpu/utils/logger.py:14-54): a log
appended to ``<folder>/logs_train/<data>/<train.name>/<config>_<time>.log``
(``logs_sample`` for sampling) and checkpoints under
``<folder>/checkpoints/<data>/``, named ``<train.name>_<time>``.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple


class Logger:
    def __init__(self, file_path: Optional[str] = None, verbose: bool = True):
        self.file_path = file_path
        self.verbose = verbose
        if file_path:
            os.makedirs(os.path.dirname(file_path), exist_ok=True)

    def log(self, msg: str, verbose: Optional[bool] = None) -> None:
        if self.file_path:
            with open(self.file_path, "a") as f:
                f.write(msg + "\n")
        if self.verbose if verbose is None else verbose:
            print(msg, flush=True)


def set_log(config, is_train: bool = True) -> Tuple[str, str, str]:
    """Create the log and checkpoint directories; return (log folder, log
    name, checkpoint name)."""
    data = str(config.data.data)
    exp_name = str(config.train.name)
    ts = time.strftime("%b%d-%H-%M-%S")
    log_name = f"{config.get('config_name', 'config')}_{ts}"
    root = config.get("folder", "./")
    folder = os.path.join(root, "logs_train" if is_train else "logs_sample", data, exp_name)
    os.makedirs(folder, exist_ok=True)
    os.makedirs(os.path.join(root, "checkpoints", data), exist_ok=True)
    return folder, log_name, f"{exp_name}_{ts}"
