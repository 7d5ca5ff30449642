"""Third-party graph-library adapters (reference: bindings/; counterpart of
``kaminpar_tpu/integrations/``)."""

from .networkit import KaMinParNetworKit  # noqa: F401
