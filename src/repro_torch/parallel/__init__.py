"""Distribution: sharding rules (``sharding``), the live mesh and its
collectives (``collectives``)."""
from repro_torch.parallel.sharding import (
    batch_shardings,
    cache_shardings,
    param_shardings,
    param_spec,
    qtensor_shardings,
    qtensor_spec,
)
