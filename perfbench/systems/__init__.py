"""The systems a configuration can name (``"system"``), one module each."""
