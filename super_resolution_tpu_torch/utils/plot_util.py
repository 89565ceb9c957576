"""Training-curve helpers (port of super_resolution_tpu/utils/
plot_util.py; ref: basicsr/utils/plot_util.py).

Read scalar curves back out of TensorBoard event files (``tensorboard`` is
imported only there) or the text train log, and the reference's
exponential smoothing.
"""

from __future__ import annotations

import re


def read_data_from_tensorboard(log_path: str, tag: str):
    """(ref: plot_util.py:4-20)."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    ea = EventAccumulator(log_path)
    ea.Reload()
    scalar_list = ea.Tags()["scalars"]
    print("tag list: ", scalar_list)
    steps = [int(s.step) for s in ea.Scalars(tag)]
    values = [s.value for s in ea.Scalars(tag)]
    return steps, values


def read_data_from_txt_2v(path: str, pattern: str, step_one: bool = False):
    """Two-group pattern -> (steps, values) (ref: plot_util.py:23-45)."""
    with open(path) as f:
        lines = [line.strip() for line in f]
    steps, values = [], []
    pattern = re.compile(pattern)
    for line in lines:
        match = pattern.match(line)
        if match:
            steps.append(int(match.group(1)))
            values.append(float(match.group(2)))
    if step_one:
        steps = list(range(1, len(values) + 1))
    return steps, values


def read_data_from_txt_1v(path: str, pattern: str):
    """One-group pattern -> values (ref: plot_util.py:48-65)."""
    with open(path) as f:
        lines = [line.strip() for line in f]
    values = []
    pattern = re.compile(pattern)
    for line in lines:
        match = pattern.match(line)
        if match:
            values.append(float(match.group(1)))
    return values


def smooth_data(values, smooth_weight: float):
    """Exponential smoothing (ref: plot_util.py:68-88)."""
    values_sm = []
    last_sm_value = values[0]
    for value in values:
        value_sm = last_sm_value * smooth_weight + (1 - smooth_weight) * value
        values_sm.append(value_sm)
        last_sm_value = value_sm
    return values_sm
