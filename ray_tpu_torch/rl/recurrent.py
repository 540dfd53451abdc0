"""Memory models (LSTM / attention policies): only the catalog's switch.

Port of ``ray_tpu/rl/recurrent.py:419-421``. ``RecurrentPolicy`` and
``RecurrentPPOLearner`` are not ported yet (ROADMAP Queue 1: rl/); the
algorithms raise ``NotImplementedError`` for a model config that asks for
them.
"""

from __future__ import annotations

from typing import Any, Dict


def uses_memory_model(model_config: Dict[str, Any]) -> bool:
    return bool(model_config.get("use_lstm")
                or model_config.get("use_attention"))
