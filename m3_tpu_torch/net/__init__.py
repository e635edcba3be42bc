"""The RPC plane's pieces the query layer needs (``resilience``: the
ambient deadline)."""
