"""Observability of the port: its own metrics registry (``metrics``),
span tracing (``trace``), kernel-build accounting (``compile``) and
deadline tracking (``slo``)."""
