"""Host-side data records the port needs."""
