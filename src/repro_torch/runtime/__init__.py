"""Host-side runtime: retries, watchdog and the crash-restart driver."""
