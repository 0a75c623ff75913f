"""Input system — 4-state buttons, string-bindable axes.

Counterpart of vvr_tpu/utils/input.py (host code, the same states). The
headless analog of src/input.rs: the same Pressed/Held/Released/None button
model (:45-57), name-bindable buttons and axes (:116-166), and the per-frame
state decay (`update`, :304-319). Events are fed programmatically (scripted
flythroughs, tests, or a terminal frontend) instead of winit.
"""

from __future__ import annotations

import dataclasses
import enum


class ButtonState(enum.Enum):
    PRESSED = 0   # went down this frame
    HELD = 1      # down for more than one frame
    RELEASED = 2  # went up this frame
    NONE = 3

    def pressed(self) -> bool:
        return self is ButtonState.PRESSED

    def held(self) -> bool:
        return self in (ButtonState.PRESSED, ButtonState.HELD)

    def released(self) -> bool:
        return self is ButtonState.RELEASED


@dataclasses.dataclass
class Input:
    buttons: dict = dataclasses.field(default_factory=dict)
    axes: dict = dataclasses.field(default_factory=dict)
    bindings: dict = dataclasses.field(default_factory=dict)

    def bind_button(self, name: str, key: str):
        self.bindings.setdefault(key, []).append(name)

    # ---- event feed (the winit handler analog, input.rs:220-300)
    def key_down(self, key: str):
        for name in self.bindings.get(key, [key]):
            cur = self.buttons.get(name, ButtonState.NONE)
            if not cur.held():
                self.buttons[name] = ButtonState.PRESSED

    def key_up(self, key: str):
        for name in self.bindings.get(key, [key]):
            self.buttons[name] = ButtonState.RELEASED

    def mouse_move(self, dx: float, dy: float):
        self.axes["mouse_x"] = self.axes.get("mouse_x", 0.0) + dx
        self.axes["mouse_y"] = self.axes.get("mouse_y", 0.0) + dy

    def scroll(self, delta: float):
        self.axes["scroll"] = self.axes.get("scroll", 0.0) + delta

    # ---- queries (input.rs:208-215)
    def get_button(self, name: str) -> ButtonState:
        return self.buttons.get(name, ButtonState.NONE)

    def get_axis(self, name: str) -> float:
        return self.axes.get(name, 0.0)

    def update(self):
        """Per-frame decay (input.rs:304-319): PRESSED -> HELD,
        RELEASED -> NONE; per-frame axes reset."""
        for k, v in list(self.buttons.items()):
            if v is ButtonState.PRESSED:
                self.buttons[k] = ButtonState.HELD
            elif v is ButtonState.RELEASED:
                self.buttons[k] = ButtonState.NONE
        self.axes["scroll"] = 0.0
