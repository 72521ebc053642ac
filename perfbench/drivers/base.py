"""What every driver of the served model shares: the weights from the seed,
the one calibration pass, and the clock."""
from __future__ import annotations

from time import perf_counter as now  # noqa: F401  (the drivers' clock)

import torch

from perfbench import weights, work


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Served:
    """Set-up shared by the serving drivers: the benchmark's weights on the
    device and the program's calibration of every TD-VMM site's readout
    window on the cell's calibration batch."""
    kind = "decode"

    def __init__(self, cell, seed: int, device, cfg):
        self.cell, self.seed, self.device, self.cfg = cell, seed, device, cfg
        self.run = cell.run
        self.mix = cell.mix
        self.shape = work.Shape.from_run(self.run)
        self.params = None
        self.calib = None

    def setup_model(self) -> None:
        from repro_torch.models import model
        self.params = weights.make(self.run, self.seed, self.device,
                                   self.cfg.padded_vocab)
        with torch.no_grad():
            self.calib = model.calibrate(
                self.params,
                {"inputs": torch.as_tensor(self.cell.calibration)},
                self.cfg, device=self.device)

    def release(self) -> dict:
        """Free the program's state; returns the weights for the reference."""
        params = self.params
        self.params = self.calib = None
        return params
