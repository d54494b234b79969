from diffndm_tpu_torch.parallel.mesh import (DataGroup,  # noqa: F401
                                             all_gather_rows,
                                             all_reduce_flat,
                                             init_data_group, pad_rows,
                                             replicate, shard_rows, spawn)
