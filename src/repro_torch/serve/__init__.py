from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet import ArrayFleet, make_serving
from repro_torch.serve.placement import (ArrayView, PlacementPolicy,
                                         make_policy, partition_devices)

__all__ = ["Request", "ServeEngine", "ArrayFleet", "make_serving",
           "ArrayView", "PlacementPolicy", "make_policy",
           "partition_devices"]
