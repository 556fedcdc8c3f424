"""Hardware constants of the reference's cost model.

These are the reference package's TPU v5e-class per-chip numbers
(``repro/launch/mesh.py``), copied so that the port's scheduler prices
admission exactly as the reference does.  They describe that TPU model,
not the GPU the port runs on, and are used only by the cost engine
(``core/costs.py``) to price the scheduler's admission decisions.
"""

# Hardware constants for the roofline (TPU v5e-class chip).
PEAK_FLOPS_BF16 = 197e12      # per chip
HBM_BW = 819e9                # bytes/s per chip
ICI_BW = 50e9                 # bytes/s per link (~usable)
