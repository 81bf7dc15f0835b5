def create_app(app):
    @app.get("/health/ready")
    async def ready():
        return {}

    return app
