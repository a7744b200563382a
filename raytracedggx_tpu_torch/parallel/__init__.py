from .sharded import (ShardedRenderer, halo_exchange_rows,  # noqa: F401
                      make_row_mesh)
