"""Named solver presets — the framework's "model zoo"; a copy of
``cytvdn_tpu/presets.py`` kept inside the port, value for value.

The reference exposes its algorithm variants implicitly through the
defaults of ``denoise3D``/``denoise4D`` (4D: 10 FISTA
iterations, λ=μ/32, cyTVDN.py:22-23,67-68; 3D: 7500 unaccelerated
iterations, λ=μ/16, cyTVDN.py:253-256,294-295). Here each variant is a
first-class named configuration; ``get_preset(name)`` returns the kwargs
for :func:`cytvdn_tpu_torch.denoise`.
"""

from __future__ import annotations

from typing import Any, Dict

#: name -> (description, denoise kwargs)
PRESETS: Dict[str, Dict[str, Any]] = {
    # the reference's 3D EELS default (cyTVDN.py:250-256)
    "eels3d": dict(
        iterations=7500, FISTA=False, BC_mode=2,
        stopping_relative_change=0.05,
    ),
    # accelerated 3D: FISTA converges in far fewer iterations
    # (reference cyTVDN.py:39-40)
    "eels3d-fista": dict(
        iterations=500, FISTA=True, BC_mode=2,
        stopping_relative_change=0.05,
    ),
    # the reference's 4D-STEM default (cyTVDN.py:19-23)
    "stem4d": dict(iterations=10, FISTA=True, BC_mode=2),
    # 4D with convergence-driven stopping
    "stem4d-converged": dict(
        iterations=200, FISTA=True, BC_mode=2,
        stopping_relative_change=0.05,
    ),
    # half-isotropic variants (experimental in the reference, README.md:9)
    "stem4d-iso": dict(
        iterations=10, FISTA=True, BC_mode=2,
        isotropic_R=True, isotropic_Q=True,
    ),
    # hybrid schedule: FISTA burst then unaccelerated polish
    # (reference cyTVDN.py:100-108)
    "stem4d-hybrid": dict(iterations=(20, 20), BC_mode=2),
}


def get_preset(name: str) -> Dict[str, Any]:
    """kwargs for :func:`cytvdn_tpu_torch.denoise` under a named preset."""
    try:
        return dict(PRESETS[name])
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None


def denoise_preset(datacube, mu, preset: str, *, device="cuda", **overrides):
    """Run a named preset on ``device`` (overrides win)."""
    from cytvdn_tpu_torch import denoise

    kwargs = get_preset(preset)
    kwargs.update(overrides)
    return denoise(datacube, mu, device=device, **kwargs)
