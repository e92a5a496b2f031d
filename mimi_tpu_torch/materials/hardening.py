"""Hardening laws as differentiable torch functions.

Counterpart of mimi_tpu/materials/hardening.py (the reference's
material_hardening.hpp), with the same attribute names: `sigma_y`, `n`,
`eps0`, `A`, `B`, `C`, `eps0_dot`, `reference_temperature`, `m`, ...

Each law exposes
  evaluate(eqps)                 -> flow stress (differentiable in eqps)
  evaluate_grad(eqps)            -> its derivative
  visco_evaluate(eqps, eqps_dot) -> flow stress x rate contribution
  rate_contribution(rate)        -> multiplier (piecewise), and
  rate_contribution_grad(rate)      its derivative
  thermo_contribution(T)         -> multiplier
  sigma_y_value()                -> initial yield, used for solver tolerances
Inputs are tensors or Python numbers (a number is taken as a float64
tensor, and the result is a 0-d tensor); the guards keep forward-mode
derivatives NaN-free.
"""

from __future__ import annotations

import torch


def _t(x):
    """A tensor input as it is; a Python number as a float64 0-d tensor."""
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float64)


class Hardening:
    def name(self):
        return type(self).__name__

    def is_rate_dependent(self):
        return False

    def is_temperature_dependent(self):
        return False

    def initialize_temperature(self, initial, melting):
        pass

    def validate(self):
        pass

    def rate_contribution(self, rate):
        return 1.0

    def rate_contribution_grad(self, rate):
        """d rate_contribution / d rate."""
        return 0.0

    def thermo_contribution(self, temperature):
        return 1.0

    def evaluate(self, eqps):
        raise NotImplementedError

    def evaluate_grad(self, eqps):
        """d evaluate / d eqps."""
        raise NotImplementedError

    def visco_evaluate(self, eqps, eqps_dot):
        raise NotImplementedError(
            f"{self.name()}: visco_evaluate needs a rate-dependent law"
        )

    def sigma_y(self):
        return self.sigma_y_value()

    def sigma_y_value(self):
        raise NotImplementedError


class PowerLawHardening(Hardening):
    def __init__(self):
        self.sigma_y = 0.0
        self.n = 0.0
        self.eps0 = 0.0

    def evaluate(self, eqps):
        return self.sigma_y * (1.0 + _t(eqps) / self.eps0) ** (1.0 / self.n)

    def evaluate_grad(self, eqps):
        eqps = _t(eqps)
        return (self.sigma_y / (self.n * self.eps0)) * (
            1.0 + eqps / self.eps0
        ) ** (1.0 / self.n - 1.0)

    def sigma_y_value(self):
        return self.sigma_y


class VoceHardening(Hardening):
    def __init__(self):
        self.sigma_y = 0.0
        self.sigma_sat = 0.0
        self.strain_constant = 0.0

    def evaluate(self, eqps):
        return self.sigma_sat - (self.sigma_sat - self.sigma_y) * torch.exp(
            -_t(eqps) / self.strain_constant
        )

    def evaluate_grad(self, eqps):
        return ((self.sigma_sat - self.sigma_y) / self.strain_constant) * (
            torch.exp(-_t(eqps) / self.strain_constant)
        )

    def sigma_y_value(self):
        return self.sigma_y


class JohnsonCookHardening(Hardening):
    def __init__(self):
        self.A = 0.0
        self.B = 0.0
        self.n = 0.0

    def evaluate(self, eqps):
        # A for |eqps| < 1e-13; the double where keeps the derivative
        # finite at eqps == 0 (0**(n-1) would be inf)
        eqps = _t(eqps)
        small = eqps.abs() < 1.0e-13
        safe = torch.where(small, torch.ones_like(eqps), eqps)
        return torch.where(small, self.A, self.A + self.B * safe**self.n)

    def evaluate_grad(self, eqps):
        eqps = _t(eqps)
        small = eqps.abs() < 1.0e-13
        safe = torch.where(small, torch.ones_like(eqps), eqps)
        return torch.where(small, 0.0, self.B * (self.n * safe ** (self.n - 1.0)))

    def sigma_y_value(self):
        return self.A


class JohnsonCookRateDependentHardening(JohnsonCookHardening):
    def __init__(self):
        super().__init__()
        self.C = 0.0
        self.eps0_dot = 0.0

    def is_rate_dependent(self):
        return True

    def visco_evaluate(self, eqps, eqps_dot):
        return self.evaluate(eqps) * self.rate_contribution(eqps_dot)

    def rate_contribution(self, rate):
        # log guard: below the reference rate the contribution is 1 and
        # log is never evaluated at rate <= 0
        rate = _t(rate)
        active = rate > self.eps0_dot
        safe = torch.where(active, rate, torch.full_like(rate, self.eps0_dot))
        return torch.where(
            active, 1.0 + self.C * torch.log(safe / self.eps0_dot), 1.0
        )

    def rate_contribution_grad(self, rate):
        rate = _t(rate)
        active = rate > self.eps0_dot
        safe = torch.where(active, rate, torch.full_like(rate, self.eps0_dot))
        return torch.where(active, self.C / safe, 0.0)


class JohnsonCookTemperatureAndRateDependentHardening(
    JohnsonCookRateDependentHardening
):
    def __init__(self):
        super().__init__()
        self.reference_temperature = 0.0
        self.melting_temperature = 0.0
        self.m = 0.0

    def is_temperature_dependent(self):
        return True

    def initialize_temperature(self, initial, melting):
        self.melting_temperature = melting

    def validate(self):
        if self.reference_temperature > self.melting_temperature:
            raise ValueError(
                "reference temperature can't be bigger than melting "
                "temperature."
            )

    def thermo_contribution(self, temperature):
        t_ref = self.reference_temperature
        t_mel = self.melting_temperature
        temperature = _t(temperature)
        theta = (temperature - t_ref) / (t_mel - t_ref)
        return torch.where(
            temperature < t_ref,
            1.0,
            torch.where(
                temperature > t_mel,
                0.0,
                1.0 - torch.clamp(theta, min=0.0) ** self.m,
            ),
        )


class JohnsonCookViscoConstantTemperatureHardening(
    JohnsonCookTemperatureAndRateDependentHardening
):
    """Constant-temperature JC: the thermal factor is fixed at setup."""

    def __init__(self):
        super().__init__()
        self.temperature = -1.0
        self._temperature_contribution = -1.0

    def is_temperature_dependent(self):
        return False

    def initialize_temperature(self, initial, melting):
        self.melting_temperature = melting
        self.set_temperature(initial)

    def set_temperature(self, temp):
        self.temperature = temp
        val = 1.0 - (
            (temp - self.reference_temperature)
            / (self.melting_temperature - self.reference_temperature)
        ) ** self.m
        if val <= 0.0:
            raise ValueError(f"Invalid temperature contribution {val}")
        self._temperature_contribution = val

    def thermo_contribution(self, temperature):
        return self._temperature_contribution
