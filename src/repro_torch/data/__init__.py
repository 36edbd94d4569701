"""Dataset substrate: copies of the reference's ``repro.data`` workload
generators (paper §V-A1), plus the LM training pipeline's token store
(``tokens``) and stateless batch loader (``loader``)."""

from repro_torch.data.datasets import (  # noqa: F401
    cropland_like,
    synthetic_multi_column,
    synthetic_single_column,
)
from repro_torch.data.tpch import lineitem_like, orders_like, part_like  # noqa: F401
from repro_torch.data.tpcds import (  # noqa: F401
    catalog_returns_like,
    catalog_sales_like,
    customer_demographics_like,
)
