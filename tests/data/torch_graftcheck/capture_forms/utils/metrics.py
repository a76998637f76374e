class Metrics:
    def inc(self, name, n=1):
        pass


global_metrics = Metrics()
