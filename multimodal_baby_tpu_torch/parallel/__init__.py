from multimodal_baby_tpu_torch.parallel.mesh import (
    Mesh, create_mesh, local_device, local_rows, make_param_shardings,
    padded_rows, param_pspec, shard_batch, world,
)
