"""Speaker tower: log-fbank, ResNet293-SimAM + ASP, LDA → the 128-d speaker embedding."""
