from abc_tpu_torch.parallel.mesh import (  # noqa: F401
    DistComm, LocalComm, Mesh, init_process_group_for,
)
from abc_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, sharded_key_switch, sharded_rotate_rows,
)
