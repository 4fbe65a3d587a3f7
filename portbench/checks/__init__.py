"""The comparisons that decide `correct`, one module per traffic driver."""
