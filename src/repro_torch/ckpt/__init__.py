from .checkpoint import (CkptStats, async_save, io_cost, latest_step,
                         range_owners, restore, save)
