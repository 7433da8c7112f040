"""ClusterSpec — the device-topology half of an Engine.

One object owns everything that is *per-cluster* rather than per-model:
the device list, the per-rank memory budget the planners schedule
against, the bandwidth topology for Eq. 9, and the GroupPool (bucket
ladder + built-step cache) every engine on this cluster shares.

Devices are CUDA cards unless the caller asks for the host: with
`device=None` a spec resolves to every visible card and raises when
there is none — it never falls back to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch

from ..core.cost_model import Hardware
from ..core.group_pool import GroupPool, pow2_bucket


def resolve_devices(device: Optional[str] = None) -> List[torch.device]:
    """`None`/"cuda" -> every visible card; "cuda:i" -> that card;
    "cpu" -> the host. Raises when a card is asked for and none is
    visible."""
    name = "cuda" if device is None else str(device)
    if name == "cpu":
        return [torch.device("cpu")]
    if not name.startswith("cuda"):
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the "
            "host")
    if name == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(name)]


@dataclasses.dataclass
class ClusterSpec:
    """Devices + GroupPool ownership.

    `devices=None` resolves from `device` at construction (see
    `resolve_devices`).
    `mem_budget` is the per-rank budget E of Eq. 3, in the cost model's
    `m_token` unit (plain tokens for `demo_cost_model`). `bucketing`
    picks the GroupPool's padding-bucket ladder ("pow2" | "geometric" |
    "mult256", or a callable n -> bucket)."""

    devices: Optional[Sequence[torch.device]] = None
    device: Optional[str] = None
    mem_budget: float = 1024.0
    hardware: Hardware = dataclasses.field(default_factory=Hardware)
    bucketing: Any = "pow2"
    max_executables: Optional[int] = None
    _pool: Optional[GroupPool] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        self.resolved_devices()      # no card and no device="cpu": raise

    # -- resolution -----------------------------------------------------
    def resolved_devices(self) -> List[torch.device]:
        if self.devices is None:
            self.devices = resolve_devices(self.device)
        return list(self.devices)

    @property
    def primary(self) -> torch.device:
        """The device a single-card engine places its model on."""
        return self.resolved_devices()[0]

    @property
    def n_devices(self) -> int:
        return len(self.resolved_devices())

    @property
    def n_replicas(self) -> int:
        """Number of CP-schedulable ranks — the N the planners allocate
        over (one rank per device; tensor parallelism is not ported)."""
        return self.n_devices

    # -- owned resources ------------------------------------------------
    def pool(self) -> GroupPool:
        """The cluster's GroupPool (created once, shared by engines)."""
        if self._pool is None:
            self._pool = GroupPool(bucket_fn=self.bucketing,
                                   max_executables=self.max_executables)
        return self._pool

    def decode_shape(self, n_active: int, context_len: int, *,
                     min_slots: int = 2) -> tuple:
        """Bucket a serving decode shape: (slot count, cache length).

        Slot counts ride a pow2 ladder from `min_slots`, cache lengths
        the pool's configured padding ladder, so the slot decode step
        sees one shape per rung instead of one per trace."""
        slots = pow2_bucket(max(int(n_active), 1), minimum=min_slots)
        return slots, self.pool().bucket(int(context_len))

    # -- constructors ----------------------------------------------------
    @classmethod
    def auto(cls, *, device: Optional[str] = None,
             mem_budget: float = 1024.0,
             hardware: Optional[Hardware] = None,
             bucketing: Any = "pow2",
             max_executables: Optional[int] = None) -> "ClusterSpec":
        """Spec over every visible card (or the host with device="cpu")."""
        return cls(devices=None, device=device, mem_budget=mem_budget,
                   hardware=hardware or Hardware(), bucketing=bucketing,
                   max_executables=max_executables)
