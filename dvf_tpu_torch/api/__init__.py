"""The Filter contract."""
