"""Physical and design constants from the paper (55 nm ESF3 NOR-flash process).

All values are taken from Bavandpour, Mahmoodi & Strukov, "Energy-Efficient
Time-Domain Vector-by-Matrix Multiplier for Neurocomputing and Beyond" (2017),
sections 3-4, unless marked [fitted] (behavioral-model constants fitted to the
paper's reported anchor numbers, see core/energy.py and core/nonideal.py).
"""
from __future__ import annotations

import dataclasses

# --- Timing (section 4.2) ---------------------------------------------------
T0_S = 0.5e-9           # per-bit half-window: 2*T0 <= 1 ns  => T0 = 0.5 ns
TAU_RESET_S = 2.0e-9    # output-capacitor pre-charge time (pipelining period 2T+tau)
TAU_F_S = 0.2e-9        # S-R latch + rectify-linear propagation delay (negligible vs T)

# --- Voltages (section 4.1) -------------------------------------------------
V_RESET = 0.7           # pre-charged drain-line voltage [V]
DELTA_VD = 0.2          # drain-line swing V_RESET - V_TH [V]
V_TH_LATCH = V_RESET - DELTA_VD   # S-R latch switching threshold [V]
V_CG = 1.2              # control-gate logic voltage [V]
V_SG_OPT = 0.8          # select-gate optimum (Fig. 4a) [V]
V_T_THERMAL = 0.0258    # thermal voltage at 300 K [V]
VTH_MISMATCH_RMS = 0.020  # S-R latch V_TH mismatch, Monte-Carlo (section 4.1) [V]

# --- Currents (section 4.1, Fig. 4) ------------------------------------------
I_MAX_OPT = 1.0e-6      # optimal max drain current ~1 uA (Fig. 4a)
DIBL_ERROR_AT_OPT = 0.02  # relative output error < 2% at optimum => >=5..6 bit

# --- Capacitances (sections 3.2, 4.2) ----------------------------------------
C_PER_INPUT = 0.04e-12  # conservative external cap per input: C ~= 200*C_drain [F]
C_DRAIN_PER_INPUT = C_PER_INPUT / 200.0

# --- Energy anchors from the paper (section 4.2 / Fig. 5) --------------------
# 6-bit digital-input/digital-output VMM, conservative design.
E_TOTAL_N10_J = 5.44e-12       # total energy for a 10x10 VMM window
TOPS_PER_J_N10 = 38.6e12 / 1e12   # 38.6 TOps/J
TOPS_PER_J_N100 = 120.0        # ~120 TOps/J
TOPS_PER_J_N1000 = 150.0       # ~150 TOps/J
STATIC_FRACTION_N10 = 0.65     # static energy ~65% of total at N=10

# --- Area anchors (section 4.2, Fig. 3/5b) ------------------------------------
AREA_CAP_FRACTION_LARGE_N = 0.75   # external caps ~75% of area for N > 200
AREA_MEM_FRACTION_LARGE_N = 0.25   # memory array ~25%
# [fitted] 55nm ESF3 supercell (2 FG cells sharing EG/SG): ~0.4 um^2 each;
# a four-quadrant weight needs 4 cells = 2 supercells.
A_SUPERCELL_UM2 = 0.40
# [fitted] MOSCAP density in 55 nm: ~6 fF/um^2 => 0.04 pF => ~6.7 um^2/input.
MOSCAP_F_PER_UM2 = 6.0e-15

# --- Default computing precision ---------------------------------------------
DEFAULT_BITS = 6        # DIBL-limited precision ceiling (abstract, section 4.1)

# --- NVIDIA H100 SXM published peaks (data sheet, dense; used for bounds) ----
H100_HBM_BW = 3.35e12            # bytes/s
H100_INT8_OPS = 1979e12          # int8 tensor-core ops/s
H100_BF16_FLOPS = 989e12         # bf16 tensor-core FLOP/s
# TF32 tensor-core FLOP/s: the basis of the port's float32 products (B1/B2's
# 3xTF32 storage counts its three products at this rate, B3 and B4 theirs)
H100_TF32_FLOPS = 495e12
H100_HBM_BYTES = 80e9            # HBM3 capacity of one card
H100_NVLINK_BW = 450e9           # NVLink 4, bytes/s per direction per GPU
H100_NODE_GPUS = 8               # GPUs joined by NVLink in one node
H100_IB_BW = 50e9                # InfiniBand NDR 400 Gb/s, one NIC per GPU


@dataclasses.dataclass(frozen=True)
class TDVMMSpec:
    """Operating point of a time-domain VMM tile.

    The ideal math only needs (bits, w_max); the physical constants feed the
    non-ideality and energy models.
    """
    bits: int = DEFAULT_BITS           # input/output time-code precision p
    weight_bits: int = 6               # effective weight programming precision
    w_max: float = 1.0                 # weight magnitude bound
    i_max: float = I_MAX_OPT           # max current per source [A]
    v_sg: float = V_SG_OPT             # select-gate bias [V]
    delta_vd: float = DELTA_VD         # drain swing [V]
    t0_s: float = T0_S                 # half-window per bit
    c_per_input_f: float = C_PER_INPUT

    @property
    def t_window_s(self) -> float:
        """T: the input window length for p-bit precision."""
        return self.t0_s * (2 ** self.bits)

    @property
    def latency_s(self) -> float:
        """2T + tau_reset: pipelined VMM period (section 4.2)."""
        return 2.0 * self.t_window_s + TAU_RESET_S

    def c_total_f(self, n: int) -> float:
        """Total output-line capacitance for an N-input column."""
        return self.c_per_input_f * n

    def v_th_charge(self, n: int) -> float:
        """K = C*V_TH: the charge threshold for an N-input column [C].

        Defined via Eq. 5 so that I_max = C*V_TH / (N*T) exactly.
        """
        return n * self.i_max * self.t_window_s
