"""The four architecture families of the quality gate (tools/arch_knobs.py
of the JAX package, copied): each family's MODEL-knob deltas on the flagship
recipe (SDTPS + DGAF v3 DeMo, config/presets.py::apply_flagship), and its
operating point on the gate's dataset.

ARCH_KNOBS:
  demo      the flagship, SDTPS + DGAF v3;
  parallel  DeMo_Parallel, nine heads, with the reference engine's loss
            weighting (only the first pair at SDTPS_LOSS_WEIGHT:
            MODEL.PARALLEL_LOSS_PARITY);
  legacy    the DeMoBeiyong cascade, SACR -> LIF -> SDTPS -> DGAF, with
            LIF's auxiliary loss;
  frca      the FRCA token selector alone (USE_FRCA True, no SDTPS
            weighting, no DGAF).

GATE_POINTS: the hard recipe's identity weight (`id_weight`) and the peak
learning rate (`base_lr`, None for the flagship recipe's) at which each
family learns the gate's dataset without saturating, as the JAX package
pinned them: the families learn at very different rates, so one id_weight
cannot put them all inside the gate's band.
"""

ARCH_KNOBS = {
    "demo": dict(),
    "parallel": dict(ARCH="DeMo_Parallel", PARALLEL_LOSS_PARITY=True),
    "legacy": dict(ARCH="DeMoBeiyong", USE_SACR=True, USE_LIF=True),
    "frca": dict(USE_FRCA=True, USE_SDTPS=False, USE_DGAF=False),
}

GATE_POINTS = {
    "demo": dict(id_weight=0.14, base_lr=None),
    "parallel": dict(id_weight=0.12, base_lr=None),
    "legacy": dict(id_weight=0.06, base_lr=None),
    "frca": dict(id_weight=0.18, base_lr=1.5e-4),
}
