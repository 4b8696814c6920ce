"""Retainer-pool pay and switch constants (paper §3, §6.3).

Workers are paid to wait ($0.05/min) and per record ($0.02/record),
terminated straggler assignments included; a terminated worker loses a
dialog-click delay before taking new work. The port keeps its own copy of
the values in ``src/repro/core/crowd.py``.
"""
WAIT_PAY_PER_S = 0.05 / 60.0
WORK_PAY_PER_RECORD = 0.02
SWITCH_DELAY_S = 2.0      # dialog-click delay on termination (§6.3)
