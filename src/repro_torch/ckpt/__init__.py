from .checkpoint import (CkptStats, async_save, latest_step, restore,
                         save)
