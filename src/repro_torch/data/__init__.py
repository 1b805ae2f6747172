"""Host-side data: the ``DataSource`` protocol and synthetic generators
(numpy only)."""
