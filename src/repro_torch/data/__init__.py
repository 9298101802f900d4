from .pipeline import SyntheticTokens, FileTokens, make_batch
