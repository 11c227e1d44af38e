"""Data: the synthetic OHLCV stand-in for market data."""

from montecarlo_tpu_torch.data.synthetic import generate_ohlcv  # noqa: F401
