"""Host-side data structures: channels and microplate layouts."""
