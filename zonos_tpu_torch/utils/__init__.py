"""Weight loading, checkpoint export and the native checkpoint format."""
