class Searcher:
    def renamed(self):
        pass
