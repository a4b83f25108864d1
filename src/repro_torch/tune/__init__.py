"""`python -m repro_torch.tune` — manage the port's persistent tuning
registry (the JAX package's ``repro.tune`` commands).

Subcommands::

    warm          tune a layer set (Loki sweeps, H100 conv schedules)
    inspect       print the registry contents as a table
    stats         summary counts (records by kind and tier, measured)
    ecm           the three-tier sweep (roofline, ECM, exact traces)
    export        dump the registry as a JSON array
    merge         union another registry in (+ stale-machine eviction)
    sync          fleet sync round over a shared directory
    serve-report  predicted vs measured of the schedule records
    doctor        flag records whose measurement left the ratio band
    metrics       the process metrics as Prometheus text or JSON
    invalidate    drop records by kind / machine / cost-model version

See :mod:`repro_torch.core.registry` for the storage format.
"""
from repro_torch.tune.cli import main

__all__ = ["main"]
