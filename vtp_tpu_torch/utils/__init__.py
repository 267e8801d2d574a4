"""Host-side helpers of the port (image preprocessing)."""
