"""Frequency-gated triggers shared by saver/evaluator/recover (a copy of
`areal_tpu/utils/timeutil.py`).

Independent epoch/step/time sub-controls with a state_dict. Each sub-gate
tracks its own baseline: a step-triggered fire does NOT reset the seconds
gate, so e.g. freq_step=10 + freq_sec=30 fires on both cadences
independently, matching the reference semantics.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FrequencyControl:
    """Fires when `freq_epoch` epochs, `freq_step` steps, or `freq_sec`
    seconds have elapsed since that same gate last fired. Any may be None
    (disabled). The three gates are independent.
    """

    freq_epoch: int | None = None
    freq_step: int | None = None
    freq_sec: float | None = None
    initial_value: bool = False

    _last_epoch: int = field(default=0, repr=False)
    _last_step: int = field(default=0, repr=False)
    _last_time: float = field(default_factory=time.monotonic, repr=False)
    _total_epochs: int = field(default=0, repr=False)
    _total_steps: int = field(default=0, repr=False)
    _fired_initial: bool = field(default=False, repr=False)

    def check(self, epochs: int = 0, steps: int = 0) -> bool:
        """Accumulate progress and report whether any gate fires now."""
        self._total_epochs += epochs
        self._total_steps += steps

        if self.initial_value and not self._fired_initial:
            self._fired_initial = True
            self._last_epoch = self._total_epochs
            self._last_step = self._total_steps
            self._last_time = time.monotonic()
            return True

        fire = False
        if (
            self.freq_epoch is not None
            and self._total_epochs - self._last_epoch >= self.freq_epoch
        ):
            fire = True
            self._last_epoch = self._total_epochs
        if (
            self.freq_step is not None
            and self._total_steps - self._last_step >= self.freq_step
        ):
            fire = True
            self._last_step = self._total_steps
        if (
            self.freq_sec is not None
            and time.monotonic() - self._last_time >= self.freq_sec
        ):
            fire = True
            self._last_time = time.monotonic()
        return fire

    def state_dict(self) -> dict:
        return dict(
            last_epoch=self._last_epoch,
            last_step=self._last_step,
            total_epochs=self._total_epochs,
            total_steps=self._total_steps,
            fired_initial=self._fired_initial,
        )

    def load_state_dict(self, state: dict) -> None:
        self._last_epoch = state["last_epoch"]
        self._last_step = state["last_step"]
        self._total_epochs = state["total_epochs"]
        self._total_steps = state["total_steps"]
        self._fired_initial = state.get("fired_initial", False)
        self._last_time = time.monotonic()
