"""Drivers, one per kind of traffic: each sets a cell up, runs its timed
window and checks what the window's path produced against the plain
reference.  A driver module has ``setup(ctx)``, ``window(ctx, state,
seconds)``, ``check(ctx, state)`` and ``calibrate(ctx, control)``."""
