"""Runtime options — twin of the reference's three option structs.

* ``SkippingType`` / ``Test`` enums: src/volume_render_subpass.h:58-72.
* ``RenderOptions``: ``VolumeRenderSubpass::Options`` (same file, :74-81).
* ``VolumeOptions``: ``Volume::Options`` (src/volume_component.h:45-56).

In the reference, structural options select shader ``#define`` variants and
any change recompiles the pipeline (src/volume_render_subpass.cpp:56-93,
src/volume_render.cpp:541-544). Here they become jit *static arguments*: a
change simply keys a different executable in the jit cache.
"""

from __future__ import annotations

import dataclasses
import enum


class SkippingType(enum.IntEnum):
    NONE = 0
    BLOCK = 1
    DISTANCE = 2
    ANISOTROPIC_DISTANCE = 3


class Test(enum.IntEnum):
    NONE = 0
    RAY_ENTRY = 1
    RAY_EXIT = 2
    NUM_TEXTURE_SAMPLES = 3


@dataclasses.dataclass
class RenderOptions:
    skipping_type: SkippingType = SkippingType.DISTANCE
    clip_distance: float = 50.0
    early_ray_termination: bool = True
    depth_attachment: bool = False
    test: Test = Test.NONE
    # TRANSFER_FUNCTION_TEXTURE build variant (transfer_function.glsl:36-38):
    # sample the baked 256×256 TF texture instead of the closed form. The
    # occupancy/distance maps keep the closed-form alpha>0 test, which is a
    # superset of the texture's (u8 truncation only zeroes small alphas), so
    # skipping stays conservative-correct.
    texture_tf: bool = False
    # Quality mode: re-march resampling-suspect pixels (alpha/depth
    # discontinuities — silhouettes) with the reference-exact per-ray
    # marcher and splice them into the sweep+warp frame. Closes the w-grid
    # resampling parity gap for a ~1-3 % pixel budget; off by default (the
    # headline path matches the reference's own frame semantics).
    edge_repair: bool = False
    # Max fraction of the frame the edge-repair pass may re-march
    # (rounded up to 1024 rays for stable jit shapes). 1/32 covers the
    # intensity-TF silhouette class; gradient TFs flag many more suspects
    # (grazing-ray class, docs/PERF.md round-4 note) — parity/quality runs
    # can raise it, paying proportional oracle cost.
    repair_budget: float = 1.0 / 32.0
    # Slab quadrature density for the plane-sweep renderers. The reference
    # steps every ray at 1/(dim_max·sf) of its length
    # (volume_render.frag:176-179); a sweep slab per VOXEL PLANE gives only
    # Np samples along the principal axis — an undersampling of
    # dim_max/Np (1.68× on the beetle) that is invisible on smooth
    # intensity-only TFs (measured ≤0.04 % pixels >8/255) but produces the
    # entire gradient-TF parity gap (28 % of covered pixels at 1× density,
    # 0 % at 2×; see tests/test_sweep.py::test_grad_tf_parity_density).
    #   "auto" — dim_max-matched density × ``grad_density_mult`` for
    #            gradient TFs, plane-aligned (Np) for intensity-only TFs
    #            (measured-safe fast path);
    #   "ref"  — always dim_max-matched (reference quadrature density,
    #            multiplier NOT applied — the exact protocol A/B knob);
    #   "axis" — always Np (round-3 behavior).
    slab_density: str = "auto"
    # Extra quadrature density for gradient TFs under "auto". Gradient TFs
    # put their alpha in voxel-scale shells; at exactly the reference's
    # step density the sweep's fixed-phase slab quadrature systematically
    # under-integrates sharp shells (present-grad round-4: 9.5 % of covered
    # pixels >8/255 on device, a uniform small-amplitude alpha deficit
    # across ALL ray obliquities — scripts/density_sweep.py measured
    # 6.9 % → 2.0 % → 0.72 % → 0.66 % at 1×/1.5×/2×/3× ref density,
    # quarter scale). 2× lands on the convergence plateau; the residual
    # ~0.7 % is the grazing-ray class that edge_repair re-marches.
    grad_density_mult: float = 2.0


@dataclasses.dataclass
class VolumeOptions:
    sampling_factor: float = 1.0
    voxel_alpha_factor: float = 1.0
    use_precomputed_gradient: bool = True
    # Simple grayscale 2D transfer function parameters.
    intensity_min: float = 0.0
    intensity_max: float = 1.0
    gradient_min: float = 0.0
    gradient_max: float = 1.0

    @property
    def use_gradient(self) -> bool:
        return self.gradient_max != self.gradient_min
