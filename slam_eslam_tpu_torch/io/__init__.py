"""The log runtime: typed records in the native binary log."""
