"""Console + file logging (reference Network.setup_logger,
src/LTM/network.py:20-54)."""

import logging
from pathlib import Path
from typing import Optional


def setup_logger(log_level=logging.INFO, log_dir: Optional[str] = None,
                 name: str = "pednstream_tpu_torch") -> logging.Logger:
    if log_dir is None:
        log_dir = Path.cwd() / "outputs" / "logs"
    else:
        log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)

    logger = logging.getLogger(name)
    if not logger.handlers:
        formatter = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        )
        console = logging.StreamHandler()
        console.setFormatter(formatter)
        logger.addHandler(console)
        file_handler = logging.FileHandler(log_dir / "network.log")
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
        logger.setLevel(log_level)
    return logger
