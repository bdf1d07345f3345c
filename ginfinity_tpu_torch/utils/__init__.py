"""Device selection and run-log I/O for the port."""
