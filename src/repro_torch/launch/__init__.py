"""Node orchestration and the serving demo driver."""
