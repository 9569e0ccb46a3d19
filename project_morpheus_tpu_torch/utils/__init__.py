"""Host-side helpers: device selection, text splitting, WAV files."""
